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
// Only the [B, 16, hw] mask phases leave the chip: the [B, hw, 256] t1 and
// the [B, hw, 512] t2 never reach device memory.
//
// Bound on this card at the slice's 256 prompts x 4096 positions: the first
// product (137 GFLOP) and the second (69 GFLOP) on the tensor cores, 0.21
// ms; src is read once (537 MB, 0.16 ms). The chain's GELUs (768 a row,
// 0.8 G a call) and the norm run on the CUDA cores beside them. From t1 the
// first product is gone and the read of t1 bounds the call.
//
// bf16: `post_t1_mma_kernel`. All prompts share K1 and K2, so the call is
// one chained product over B x hw rows. A row tile of 64 is 64 prompts at
// one position: every row of it adds the same skips, so a position's s1p
// and s0p (3 KB) are read once per 64 prompts (through L1) and not once per
// prompt. A work item is such a tile at 8 consecutive positions. Persistent
// blocks of two warpgroups ("teams"), one block an SM, walk a contiguous
// range of items; K1 (128 KB) and K2 (16 KB) are loaded once a block into
// swizzled shared memory. A team loads a position's 64 src rows (32 KB) into
// its slot by `cp.async` and asks L2 for the next position's, while the
// other team computes. A warp owns 16 prompts. Per 64-wide segment q: t1 is
// a warpgroup product [64, 64] (`wgmma`, src and K1 both read from shared
// memory; from t1 the tile is read from the slot in the accumulator's
// layout instead) with the float32 sums in registers in the layout of
// `mma.sync.m16n8k16`; + s1p; the norm's two-pass statistics are quad sums
// of a row; the GELU and the round give the A fragments of the second
// product in registers; t2 is a warpgroup product [64, 128] (A from
// registers, K2 from shared memory) in two halves of 64 columns; + s0p,
// GELU, round, times the prompt's hyper (staged in shared memory for the
// item), and a quad reduce-scatter leaves
// phase 4 q + (lane % 4) of a row in one lane, which stores it: no
// register holds a phase past its segment.
//
// float32, and the `nttt_upscale_product_wmma` check route for either dtype:
// `upscale_kernel`, the first port's body (a block owns 16 positions and a
// run of prompts, K1 and the s1p tile in shared memory; WMMA products in
// bf16 with float32 tiles in shared memory).
#include "common.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

#include <type_traits>

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
  const int nv = min(kPT, hw - pos0);   // positions of the block inside hw
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
        s1_s[i] = i < nv * kM1 ? s1p[((long long)img * hw + pos0) * kM1 + i]
                               : 0.f;
    }
    const float* s0_i = s0p + (long long)img * hw * kS0;
    const T* src_b = src + ((long long)b * hw + pos0) * kD;
    if constexpr (kFromT1) {
      __syncthreads();
      // t1 arrives in T: u = t1 + s1p in float32 (kD == kM1)
      for (int i = tid; i < kPT * kM1; i += kThreads)
        u_s[i] = i < nv * kM1 ? Num<T>::to_f(src_b[i]) + s1_s[i] : 0.f;
    } else if constexpr (Num<T>::is_bf16) {
      copy_bf16(xb_s, src_b, kPT * kD, nv * kD);
    } else {
      for (int i = tid; i < kPT * kD; i += kThreads)
        x_s[i] = i < nv * kD ? Num<T>::to_f(src_b[i]) : 0.f;
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
          const bool ok = r0 + i < nv;
          float part = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = j0 + jj;
            const float z2 =
                a[i][jj] +
                (ok ? s0_i[(long long)pos * kS0 + q * kM2 + j] : 0.f);
            const float g = Num<T>::round(gelu_act<T>(z2));
            part = fmaf(hy_s[j & (kC2 - 1)], g, part);
          }
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          part += __shfl_xor_sync(0xffffffffu, part, 4);
          if ((lane & 7) == 0 && ok)
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
  dim3 grid((hw + kPT - 1) / kPT,
            (B + prompts_per_block - 1) / prompts_per_block);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)src, (const T*)k1, s1p, lnw, lnb, (const T*)k2, s0p, hyper,
      (T*)out, B, hw, prompts_per_block, ppi, eps);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16: persistent warpgroups, register accumulators (wgmma and mma.sync)

using mma::bf16;
constexpr int kRows = 64;            // prompts a row tile: 4 warps x 16
constexpr int kRun = 8;              // positions a work item
constexpr int kTeamThreads = 128;
constexpr int kMmaThreads = 2 * kTeamThreads;

// K1 [256 depth, 256 columns] and K2 [64 depth, 128 columns] in
// 128-byte-swizzled column blocks of 64 (the B operands); a src tile [64,
// 256] in column blocks of 64 (the K-major A operand of the first product).
using K1Blocks = wg::Blocks<kM1, kD>;
using K2Blocks = wg::Blocks<kM2, kC1>;
using SrcBlocks = wg::Blocks<kD, kRows>;

// Shared memory in bytes from a 1024-byte-aligned start.
struct PostSmem {
  static constexpr int kK1 = 0;
  static constexpr int kK2 = kK1 + kD * kM1 * 2;
  static constexpr int kSlotBytes = kRows * kD * 2;
  static constexpr int kSlot = kK2 + kC1 * kM2 * 2;
  static constexpr int kHyBytes = kRows * kC2 * 4;
  static constexpr int kHy = kSlot + 2 * kSlotBytes;
  static constexpr int kLn = kHy + 2 * kHyBytes;
  static constexpr int kBytes = kLn + 2 * kC1 * 4;
  static constexpr size_t kLaunch = kBytes + 1024;
};
static_assert(PostSmem::kLaunch <= 232448, "over the shared memory of a block");

// GELU, tanh form, 0.5 x (1 + tanh(sqrt(2 / pi) (x + 0.044715 x^3))), with
// the tanh on the special-function unit.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float c = 0.7978845608028654f;
  const float y = x * fmaf(c * 0.044715f, x * x, c);
  float th;
  asm("tanh.approx.f32 %0, %1;\n" : "=f"(th) : "f"(y));
  const float h = 0.5f * x;
  return fmaf(h, th, h);
}

// p[k]: this lane's share of phase k of a row; the quad's total of phase
// (lane % 4) comes back.
__device__ __forceinline__ float quad_scatter(const float (&p)[4], int t4) {
  const bool odd = t4 & 1, hi = t4 & 2;
  const float q0 = (odd ? p[1] : p[0]) +
                   __shfl_xor_sync(0xffffffffu, odd ? p[0] : p[1], 1);
  const float q1 = (odd ? p[3] : p[2]) +
                   __shfl_xor_sync(0xffffffffu, odd ? p[2] : p[3], 1);
  return (hi ? q1 : q0) + __shfl_xor_sync(0xffffffffu, hi ? q0 : q1, 2);
}

// The first product of segment q into a1: t1[:, 64 q:64 q + 64] = src
// [64, 256] @ K1[:, 64 q:64 q + 64], issued as one commit group of
// warpgroup products (both operands read from shared memory); from t1 the
// tile is read from the slot in the accumulator's layout instead.
template <bool kFromT1, int q>
__device__ __forceinline__ void t1_start(float (&a1)[8][4], const bf16* slot,
                                         const bf16* k1_s) {
  if constexpr (kFromT1) {
    const int lane = threadIdx.x & 31;
    const int rg = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2), rh = rg + 8;
    const int t4 = lane & 3;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t xg =
          *(const uint32_t*)(slot + SrcBlocks::off(rg, 8 * q + j) + 2 * t4);
      const uint32_t xh =
          *(const uint32_t*)(slot + SrcBlocks::off(rh, 8 * q + j) + 2 * t4);
      a1[j][0] = mma::lo_f(xg);
      a1[j][1] = mma::hi_f(xg);
      a1[j][2] = mma::lo_f(xh);
      a1[j][3] = mma::hi_f(xh);
    }
  } else {
    const uint64_t da = wg::pinned(wg::desc(slot, 16, 1024));
    const uint64_t db = wg::pinned(wg::desc(k1_s + q * K1Blocks::kBlock,
                                            K1Blocks::kBlock * 2, 1024));
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wg::mma_ss_t<64>(
          a1,
          wg::desc_at(da,
                      2 * ((kk >> 2) * SrcBlocks::kBlock + (kk & 3) * 16)),
          wg::desc_at(db, 2 * kk * 16 * 64), kk > 0);
    wg::commit();
  }
}

// Waits for the first product in a1.
template <bool kFromT1>
__device__ __forceinline__ void t1_wait(float (&a1)[8][4]) {
  if constexpr (!kFromT1) {
    wg::wait<0>();
    wg::fence_acc(a1);
  }
}

// The rest of segment q of one position for the warp's rows g and g + 8,
// from its first product a1: returns phase 4 q + (lane % 4) of each row.
// s1g / s0g are row g's skip rows, row g + 8's lie `dimg` s1p elements on
// (2 dimg in s0p; 0 where the two prompts share an image); hy_s holds the
// team's rows of hyper, rounded. Its wait for the second product also waits
// for a first product issued before it.
template <int q>
__device__ __forceinline__ void post_segment(
    float (&a1)[8][4], const bf16* k2_s, const float* lw_s, const float* lb_s,
    const float* s1g_, const float* s0g_, int dimg, const float* hy_s,
    float eps, float& vg, float& vh) {
  const int lane = threadIdx.x & 31, t4 = lane & 3;
  const int rg = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);
  // the skips are read where they are used, not hoisted into registers
  // ahead of the segment (read-only loads may move freely)
  const float* s1g = (const float*)wg::pinned((uint64_t)s1g_);
  const float* s0g = (const float*)wg::pinned((uint64_t)s0g_);
  // + s1p, then the norm's statistics over the row's 64 columns (a quad)
  float sg = 0.f, sh = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = kC1 * q + 8 * j + 2 * t4;
    const float2 zg = __ldg((const float2*)(s1g + col));
    const float2 zh = __ldg((const float2*)(s1g + dimg + col));
    a1[j][0] += zg.x;
    a1[j][1] += zg.y;
    a1[j][2] += zh.x;
    a1[j][3] += zh.y;
    sg += a1[j][0] + a1[j][1];
    sh += a1[j][2] + a1[j][3];
  }
  const float mug = mma::quad_sum(sg) / kC1, muh = mma::quad_sum(sh) / kC1;
  float dg = 0.f, dh = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dg += (a1[j][0] - mug) * (a1[j][0] - mug) +
          (a1[j][1] - mug) * (a1[j][1] - mug);
    dh += (a1[j][2] - muh) * (a1[j][2] - muh) +
          (a1[j][3] - muh) * (a1[j][3] - muh);
  }
  const float ig = rsqrtf(mma::quad_sum(dg) / kC1 + eps);
  const float ih = rsqrtf(mma::quad_sum(dh) / kC1 + eps);
  // GELU(norm * w + b), rounded: the A fragments of the second product
  uint32_t ua[4][4];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = 8 * j + 2 * t4;
    const float w0 = lw_s[c], w1 = lw_s[c + 1], b0 = lb_s[c], b1 = lb_s[c + 1];
    const uint32_t ug =
        mma::pack_bf16(gelu_tanh((a1[j][0] - mug) * ig * w0 + b0),
                       gelu_tanh((a1[j][1] - mug) * ig * w1 + b1));
    const uint32_t uh =
        mma::pack_bf16(gelu_tanh((a1[j][2] - muh) * ih * w0 + b0),
                       gelu_tanh((a1[j][3] - muh) * ih * w1 + b1));
    ua[j >> 1][(j & 1) * 2] = ug;
    ua[j >> 1][(j & 1) * 2 + 1] = uh;
  }
  // t2 = u [64, 64] @ K2 [64, 128] in two halves of 64 columns (phases
  // 4 q, 4 q + 1, then 4 q + 2, 4 q + 3), A from registers; + s0p, GELU,
  // round, times hyper (rounded): column 64 hh + 8 j + 2 t is phase
  // 4 q + 2 hh + j / 4, channel 8 (j % 4) + 2 t
  float pg[4] = {0.f, 0.f, 0.f, 0.f}, ph[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float a2[8][4];
    const uint64_t d2 = wg::pinned(wg::desc(k2_s + hh * K2Blocks::kBlock,
                                            K2Blocks::kBlock * 2, 1024));
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kC1 / 16; ++kk)
      wg::mma_rs<64>(a2, ua[kk], wg::desc_at(d2, 2 * kk * 16 * 64), kk > 0);
    wg::commit();
    wg::wait<0>();
    wg::fence_acc(a2);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = kM2 * q + 64 * hh + 8 * j + 2 * t4;
      const float2 zg = __ldg((const float2*)(s0g + col));
      const float2 zh = __ldg((const float2*)(s0g + 2 * dimg + col));
      const int c = 8 * (j & 3) + 2 * t4;
      const float2 yg = *(const float2*)(hy_s + rg * kC2 + c);
      const float2 yh = *(const float2*)(hy_s + (rg + 8) * kC2 + c);
      const float g0 = Num<bf16>::round(gelu_tanh(a2[j][0] + zg.x));
      const float g1 = Num<bf16>::round(gelu_tanh(a2[j][1] + zg.y));
      const float h0 = Num<bf16>::round(gelu_tanh(a2[j][2] + zh.x));
      const float h1 = Num<bf16>::round(gelu_tanh(a2[j][3] + zh.y));
      const int k = 2 * hh + (j >> 2);
      pg[k] = fmaf(g1, yg.y, fmaf(g0, yg.x, pg[k]));
      ph[k] = fmaf(h1, yh.y, fmaf(h0, yh.x, ph[k]));
    }
  }
  vg = quad_scatter(pg, t4);
  vh = quad_scatter(ph, t4);
}

// Block b owns work items [items * b / grid, items * (b + 1) / grid), its
// two teams one half each; item i is prompt tile i / (hw / 8) (prompts 64 t
// .. 64 t + 63) at positions 8 (i % (hw / 8)) .. + 7, so that an image's
// prompt tiles at the same positions follow one another.
template <bool kFromT1>
__global__ void __launch_bounds__(kMmaThreads, 1)
post_t1_mma_kernel(const bf16* __restrict__ src, const bf16* __restrict__ k1,
                   const float* __restrict__ s1p,
                   const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const bf16* __restrict__ k2,
                   const float* __restrict__ s0p,
                   const float* __restrict__ hyper, bf16* __restrict__ out,
                   int B, int hw, int ppi, float eps) {
  using L = PostSmem;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* base =
      smem_raw + ((1024u - (mma::smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* k1_s = (bf16*)(base + L::kK1);
  bf16* k2_s = (bf16*)(base + L::kK2);
  float* lw_s = (float*)(base + L::kLn);
  float* lb_s = lw_s + kC1;

  const int tid = threadIdx.x;
  const int team = tid / kTeamThreads, tt = tid % kTeamThreads;
  const int lane = tid & 31, t4 = lane & 3;
  const int rg = 16 * ((tid >> 5) & 3) + (lane >> 2);
  bf16* slot = (bf16*)(base + L::kSlot + team * L::kSlotBytes);
  float* hy_s = (float*)(base + L::kHy + team * L::kHyBytes);
  const int runs = hw / kRun;
  const int items = (B + kRows - 1) / kRows * runs;
  const int i0 = (int)((long long)items * blockIdx.x / gridDim.x);
  const int i1 = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
  const int mid = (i0 + i1 + 1) / 2;

  // the weights once a block, in the column blocks the products read
  if (!kFromT1) wg::load_rows<kM1, kD, kMmaThreads>(k1_s, k1, kM1, 0, kD, kM1);
  wg::load_rows<kM2, kC1, kMmaThreads>(k2_s, k2, kM2, 0, kC1, kM2);
  mma::cp_async_commit();
  for (int i = tid; i < kC1; i += kMmaThreads) {
    lw_s[i] = lnw[i];
    lb_s[i] = lnb[i];
  }
  mma::cp_async_wait<0>();
  wg::proxy_fence();
  __syncthreads();

  for (int item = team ? mid : i0; item < (team ? i1 : mid); ++item) {
    const int b0 = item / runs * kRows, p0 = item % runs * kRun;
    const int bg = b0 + rg, bh = bg + 8;
    const bool okg = bg < B, okh = bh < B;
    const long long ig = okg ? bg / ppi : 0, ih = okh ? bh / ppi : 0;
    const int dimg = (int)((ih - ig) * hw * kM1);
    // the tile's hyper, rounded, once the team is done with the last
    // item's (rows past B zero); the first position's barrier publishes it
    wg::bar_sync(1 + team, kTeamThreads);
    for (int i = tt; i < kRows * kC2; i += kTeamThreads) {
      const int b = b0 + i / kC2;
      hy_s[i] = b < B ? Num<bf16>::round(hyper[(long long)b0 * kC2 + i])
                      : 0.f;
    }
    // a position's 64 src rows into the slot, the next one's asked of L2
    auto load = [&](int pos) {
      // the copy's addresses are recomputed at each load, not held
      wg::load_rows<kD, kRows, kTeamThreads>(slot, src + (long long)pos * kD,
                                             hw * kD, b0, B, kD,
                                             wg::pinned(tt));
      mma::cp_async_commit();
      if (pos + 1 < p0 + kRun && tt < kRows && b0 + tt < B)
        wg::prefetch_l2(src + ((long long)(b0 + tt) * hw + pos + 1) * kD,
                        kD * 2);
    };
    load(p0);
#pragma unroll 1
    for (int pi = 0; pi < kRun; ++pi) {
      const int pos = p0 + pi;
      mma::cp_async_wait<0>();
      wg::proxy_fence();
      wg::bar_sync(1 + team, kTeamThreads);   // the tile landed
      const float* s1g = s1p + (ig * hw + pos) * kM1;
      const float* s0g = s0p + (ig * hw + pos) * kS0;
      // segment q: its first product, then the chain; the slot is free once
      // the last first product is done, and the next position's rows load
      // while the last segment's chain is computed
      auto segment = [&](auto qc) {
        constexpr int q = decltype(qc)::value;
        float a1[8][4], vg, vh;
        t1_start<kFromT1, q>(a1, slot, k1_s);
        t1_wait<kFromT1>(a1);
        if constexpr (q == 3) {
          wg::bar_sync(1 + team, kTeamThreads);
          if (pi + 1 < kRun) load(pos + 1);
        }
        post_segment<q>(a1, k2_s, lw_s, lb_s, s1g, s0g, dimg, hy_s, eps, vg,
                        vh);
        // out[b, 4 q + t, pos]
        if (okg)
          out[((long long)bg * 16 + 4 * q + t4) * hw + pos] =
              __float2bfloat16_rn(vg);
        if (okh)
          out[((long long)bh * 16 + 4 * q + t4) * hw + pos] =
              __float2bfloat16_rn(vh);
      };
      segment(std::integral_constant<int, 0>{});
      segment(std::integral_constant<int, 1>{});
      segment(std::integral_constant<int, 2>{});
      segment(std::integral_constant<int, 3>{});
    }
  }
}

template <bool kFromT1>
int launch_mma(const void* src, const void* k1, const float* s1p,
               const float* lnw, const float* lnb, const void* k2,
               const float* s0p, const float* hyper, void* out, int B, int hw,
               int ppi, float eps, cudaStream_t stream) {
  const size_t smem = PostSmem::kLaunch;
  auto kern = post_t1_mma_kernel<kFromT1>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const long long items = (long long)(B + kRows - 1) / kRows * (hw / kRun);
  // two teams a block: at most one block an SM, and no idle team
  const long long want = (items + 1) / 2;
  const int grid = (int)(want < sms ? want : sms);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)src, (const bf16*)k1, s1p, lnw, lnb, (const bf16*)k2, s0p,
      hyper, (bf16*)out, B, hw, ppi, eps);
  return (int)cudaGetLastError();
}

// The first body for either dtype.
template <typename T, bool kWSmem>
int launch_first(const void* src, const void* k1, const float* s1p,
                 const float* lnw, const float* lnb, const void* k2,
                 const float* s0p, const float* hyper, void* out, int B,
                 int hw, int prompts_per_block, int ppi, int from_t1,
                 float eps, cudaStream_t s) {
  if (from_t1)
    return launch<T, false, true>(src, k1, s1p, lnw, lnb, k2, s0p, hyper,
                                  out, B, hw, prompts_per_block, ppi, eps, s);
  return launch<T, kWSmem, false>(src, k1, s1p, lnw, lnb, k2, s0p, hyper, out,
                                  B, hw, prompts_per_block, ppi, eps, s);
}

bool bad_shape(int B, int hw, int prompts_per_block, int ppi) {
  return B < 1 || hw < 8 || hw % 8 || prompts_per_block < 1 || ppi < 1;
}

}  // namespace

// src: [B, hw, 256]; k1: [256, 256]; s1p: float [images, hw, 256]; lnw, lnb:
// float [64]; k2: [64, 128]; s0p: float [images, hw, 512]; hyper: float
// [B, 32]; out: [B, 16, hw]. Prompt b reads the skips of image b / ppi.
// from_t1 != 0: src holds t1 [B, hw, 256] and k1 is not read. hw % 8 == 0.
// bf16 takes the register-tile kernel; float32 the first port's body, whose
// block serves `prompts_per_block` prompts.
extern "C" int nttt_upscale_product(const void* src, const void* k1,
                                    const float* s1p, const float* lnw,
                                    const float* lnb, const void* k2,
                                    const float* s0p, const float* hyper,
                                    void* out, int B, int hw,
                                    int prompts_per_block, int ppi,
                                    int from_t1, float eps, int dtype,
                                    void* stream) {
  if (bad_shape(B, hw, prompts_per_block, ppi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16) {
    if (from_t1)
      return launch_mma<true>(src, k1, s1p, lnw, lnb, k2, s0p, hyper, out, B,
                              hw, ppi, eps, s);
    return launch_mma<false>(src, k1, s1p, lnw, lnb, k2, s0p, hyper, out, B,
                             hw, ppi, eps, s);
  }
  return launch_first<float, false>(src, k1, s1p, lnw, lnb, k2, s0p, hyper,
                                    out, B, hw, prompts_per_block, ppi,
                                    from_t1, eps, s);
}

// The first port's body for either dtype, arguments as
// `nttt_upscale_product`: the parent the bf16 kernel is checked and timed
// against.
extern "C" int nttt_upscale_product_wmma(const void* src, const void* k1,
                                         const float* s1p, const float* lnw,
                                         const float* lnb, const void* k2,
                                         const float* s0p, const float* hyper,
                                         void* out, int B, int hw,
                                         int prompts_per_block, int ppi,
                                         int from_t1, float eps, int dtype,
                                         void* stream) {
  if (bad_shape(B, hw, prompts_per_block, ppi))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return launch_first<__nv_bfloat16, true>(src, k1, s1p, lnw, lnb, k2, s0p,
                                             hyper, out, B, hw,
                                             prompts_per_block, ppi, from_t1,
                                             eps, s);
  return launch_first<float, false>(src, k1, s1p, lnw, lnb, k2, s0p, hyper,
                                    out, B, hw, prompts_per_block, ppi,
                                    from_t1, eps, s);
}
