// Token -> image cross-attention of the SAM2 two-way decoder, with the key
// and value projections computed on chip.
//
// Replaces the Pallas kernels `_t2i_kernel` (per-prompt keys) and
// `_t2i_pre_kernel` (layer 0, keys shared by every prompt) reached from
// `fused_t2i_attn` in no_time_to_train_tpu/ops/decoder_attention.py, and the
// pair body `_t2i_p2_kernel` (two prompts a grid step, per-prompt keys).
//
// For one prompt p, with keys [n, C] (C = 256), internal width I = 128,
// H = 8 heads of dh = 16 and T <= 16 tokens:
//   kk = round(keys @ Wk + pe_k + bk)      vv = round(keys @ Wv + bv)
//   out[t, h] = softmax_n(round(q[t, h] / sqrt(dh)) . kk[:, h]) @ vv[:, h]
// The softmax weights round to bf16 before the value product; the running
// sum uses the unrounded weights (the Pallas kernel's cast points).
// Layer 0 (pre != 0): kk and vv are the same for every prompt of an image,
// so the caller projects them once per image and the kernel reads them;
// prompt q reads image q / ppi.
//
// Bound on this card, at the slice's 256 prompts x 4096 keys: the keys are
// read once (537 MB, 0.16 ms at 3.35 TB/s) and the projections are 137
// GFLOP (0.14 ms at the bf16 tensor-core peak), so bytes and products are
// about even; the attention itself is 2 x 16 tokens a key and head.
//
// bf16: `t2i_mma_kernel`. Persistent blocks of two warpgroups ("teams"),
// one block an SM, walk a contiguous range of work items; an item is a
// chain group (one prompt, or two under kNP = 2) and a run of kRunTiles
// key tiles of 64 rows. Wk | Wv (128 KB) are loaded once a block into
// swizzled shared memory. A team loads a tile (64 x 256 keys, 32 KB) into
// its slot by `cp.async` and asks L2 for its next tile, while the other
// team computes. A warp owns 16 rows of the tile. The projection runs in four
// quarters, each one warpgroup product [64, 64] (`wgmma`, keys as A and the
// weights as B, both read from shared memory) over kk and vv of 2 heads;
// the float32 accumulators stay in registers in the layout of
// `mma.sync.m16n8k16` (csrc/mma_tile.cuh), and the attention runs on them:
// after + pe_k + bk and the round, the kk accumulator of a head (two n8
// column tiles) is the B fragment of the logits S = q kk^T, one m16n8k16
// pair with the tokens as M (T pads to 16); the softmax over keys is a quad
// reduction and the two n8 halves; the rounded weights are the A fragment
// of P V; vv's accumulator turns into P V's B fragment by `movmatrix.trans`
// in registers (no stage through shared memory, no barrier). Each warp keeps
// an online-softmax state (max, sum, [16, 128] accumulator) for its rows of
// a run. At the end of a run the 4 warps' states merge through the slot
// into one partial (m, l, O) of (prompt, run), and `t2i_merge_kernel` joins
// the runs of a prompt. Merge order: warps 0..3 of a run, then runs in key
// order; the split (runs of kRunTiles * 64 keys) depends on n alone, so the
// result depends neither on the number of SMs nor on the prompt count.
// Layer 0: the slot takes the image's kk and vv tiles (64 x 128 each, from
// L2: 2 MB an image) and `ldmatrix` gives the same fragments; only the
// attention runs. kNP = 2 names two chains an item (prompts 2b, 2b + 1),
// each computed by the same instructions as alone: bit for bit K2.
//
// float32, and the `nttt_t2i_attn_wmma` check route for either dtype:
// `t2i_kernel`, the first port's body (one block per prompt over all keys
// in tiles of 32 rows; WMMA products in bf16 with float32 tiles in shared
// memory, the attention as scalar FMAs).
#include "common.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace {

constexpr int kC = 256;
constexpr int kI = 128;
constexpr int kDh = 16;
constexpr int kBK = 32;      // key rows a tile of the first body
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
  const int nv = min(kBK, n - n0);   // rows of the tile inside n
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
        copy_bf16(xb_s, kp + (long long)n0 * kC, kBK * kC, nv * kC);
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
          const float pv =
              r < nv ? Num<T>::to_f(pe[(long long)(n0 + r) * kI + j]) : 0.f;
          kk_s[i] = Num<T>::round(kk_s[i] + pv + bk[j]);
          vv_s[i] = Num<T>::round(vv_s[i] + bv[j]);
        }
      }
    }
    if (!pre && !Num<T>::is_bf16) {
      for (int i = tid; i < kBK * kC; i += kThreads)
        x_s[i] = i < nv * kC ? Num<T>::to_f(kp[(long long)n0 * kC + i]) : 0.f;
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
            const float pv =
                r < nv ? Num<T>::to_f(pe[(long long)(n0 + r) * kI + j]) : 0.f;
            kk_s[r * kI + j] = Num<T>::round(a[i][jj] + pv + bk[j]);
          } else {
            vv_s[r * kI + j - kI] = Num<T>::round(a[i][jj] + bv[j - kI]);
          }
        }
      }
    } else if (pre) {
      // layer 0: kk in `keys`, vv in `pe`, both [images, n, kI]
      for (int i = tid; i < kBK * kI; i += kThreads) {
        const bool ok = i < nv * kI;
        kk_s[i] = ok ? Num<T>::to_f(kp[(long long)n0 * kI + i]) : 0.f;
        vv_s[i] = ok ? Num<T>::to_f(vp[(long long)n0 * kI + i]) : 0.f;
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

    // online-softmax update, one thread a column; rows past n weigh 0
    if (tid < ht) {
      const int col = tid;
      const float m_old = m_s[col];
      float m_cur = -1e30f;
      for (int r = 0; r < nv; ++r) m_cur = fmaxf(m_cur, s_s[r * 128 + col]);
      const float m_new = fmaxf(m_old, m_cur);
      const float alpha = expf(m_old - m_new);
      float sum = 0.f;
      for (int r = 0; r < kBK; ++r) {
        const float e = r < nv ? expf(s_s[r * 128 + col] - m_new) : 0.f;
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

// The first body: bf16 keeps Wk | Wv in shared memory except under pre.
template <typename T, bool kWSmem>
int launch_first(const void* keys, const void* pe, const void* tok_q,
                 const void* wkv, const float* bk, const float* bv, void* out,
                 int P, int n, int heads, int ntok, float scale, int pre,
                 long long key_stride, long long img_stride, int ppi,
                 int pair, cudaStream_t s) {
  if (pre)
    return launch<T, false, 1>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                               heads, ntok, scale, pre, key_stride,
                               img_stride, ppi, s);
  if (pair)
    return launch<T, kWSmem, 2>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                                heads, ntok, scale, pre, key_stride,
                                img_stride, ppi, s);
  return launch<T, kWSmem, 1>(keys, pe, tok_q, wkv, bk, bv, out, P, n, heads,
                              ntok, scale, pre, key_stride, img_stride, ppi,
                              s);
}

// ---------------------------------------------------------------------------
// bf16: persistent warpgroups, register accumulators (wgmma and mma.sync)

using mma::bf16;
constexpr int kH = 8;
constexpr int kTile = 64;            // key rows a tile: 4 warps x 16
constexpr int kRunTiles = 8;         // tiles a run (512 keys)
constexpr int kTeamThreads = 128;    // the 4 warps that share a work item
constexpr int kMmaThreads = 2 * kTeamThreads;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNoMax = -1e30f;     // the running max before any key

// Wk | Wv, [256 depth, 256 columns], in 128-byte-swizzled column blocks of
// 64, block b = Wk[:, 32 b:32 b + 32] | Wv[:, 32 b:32 b + 32]: quarter b of
// the projection (kk and vv of heads 2 b, 2 b + 1) is one N = 64 product. A
// key tile [64, 256] in column blocks of 64 is the K-major A operand.
using WBlocks = wg::Blocks<2 * kI, kC>;
using KeyBlocks = wg::Blocks<kC, kTile>;

// Shared memory in bytes from a 1024-byte-aligned start: the weights (not
// under pre), a ring of kStages slots a team (a key tile; under pre the kk
// and vv tiles as Tile<128>; at a run's end the warps' float accumulators in
// the first), each team's scaled q [16, 128] and its warps' (m, l) at a
// run's end, then bk and bv. Without the weights (pre) the ring is 3 deep.
template <bool kPre>
struct MmaSmem {
  static constexpr int kStages = kPre ? 3 : 1;
  static constexpr int kW = 0;
  static constexpr int kSlotBytes = kTile * kC * 2;              // 32 KB
  static constexpr int kSlot = kPre ? 0 : kC * 2 * kI * 2;
  static constexpr int kTeamSlots = kStages * kSlotBytes;
  static constexpr int kQBytes = 16 * kI * 2;
  static constexpr int kQ = kSlot + 2 * kTeamSlots;
  static constexpr int kMlBytes = 4 * 16 * kH * 8;               // float2
  static constexpr int kMl = kQ + 2 * kQBytes;
  static constexpr int kBias = kMl + 2 * kMlBytes;
  static constexpr int kBytes = kBias + 2 * kI * 4;
  static constexpr size_t kLaunch = kBytes + 1024;               // + alignment
  static_assert(kLaunch <= 232448, "over the shared memory of a block");
};

struct State {
  float o[kH][2][4];   // [head][dh tile], token rows g, g + 8
  float m[kH][2];      // running max (log2 units), tokens g, g + 8
  float l[kH][2];      // this lane's share of the running sum
};

// One head on one tile: logits S [16 tokens, 16 keys] = q kk^T, the online
// softmax, O += round(P) V. `qa`: the head's q as an A fragment; `bk`: kk as
// the B fragments of S (keys 0-7: [0], [1]; keys 8-15: [2], [3]); `bv`: vv as
// the B fragments of P V (dh 0-7: [0], [1]; dh 8-15: [2], [3]). `key0`: the
// index of the lane's first key column; keys at or past n weigh 0.
__device__ __forceinline__ void attend(State& st, int h,
                                       const uint32_t (&qa)[4],
                                       const uint32_t (&bk)[4],
                                       const uint32_t (&bv)[4], bool tail,
                                       int key0, int n) {
  float s0[4] = {0.f, 0.f, 0.f, 0.f}, s1[4] = {0.f, 0.f, 0.f, 0.f};
  mma::mma_16816(s0, qa, bk[0], bk[1]);
  mma::mma_16816(s1, qa, bk[2], bk[3]);
  if (tail) {
    const float ninf = __int_as_float(0xff800000);
    if (key0 >= n) s0[0] = s0[2] = ninf;
    if (key0 + 1 >= n) s0[1] = s0[3] = ninf;
    if (key0 + 8 >= n) s1[0] = s1[2] = ninf;
    if (key0 + 9 >= n) s1[1] = s1[3] = ninf;
  }
  const float mg = fmaxf(st.m[h][0], kLog2e * mma::quad_max(fmaxf(
      fmaxf(s0[0], s0[1]), fmaxf(s1[0], s1[1]))));
  const float mh = fmaxf(st.m[h][1], kLog2e * mma::quad_max(fmaxf(
      fmaxf(s0[2], s0[3]), fmaxf(s1[2], s1[3]))));
  const float ag = mma::fast_exp2(st.m[h][0] - mg);
  const float ah = mma::fast_exp2(st.m[h][1] - mh);
  st.m[h][0] = mg;
  st.m[h][1] = mh;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float m = e < 2 ? mg : mh;
    s0[e] = mma::fast_exp2(fmaf(s0[e], kLog2e, -m));
    s1[e] = mma::fast_exp2(fmaf(s1[e], kLog2e, -m));
  }
  st.l[h][0] = st.l[h][0] * ag + (s0[0] + s0[1] + s1[0] + s1[1]);
  st.l[h][1] = st.l[h][1] * ah + (s0[2] + s0[3] + s1[2] + s1[3]);
#pragma unroll
  for (int d = 0; d < 2; ++d) {
    st.o[h][d][0] *= ag;
    st.o[h][d][1] *= ag;
    st.o[h][d][2] *= ah;
    st.o[h][d][3] *= ah;
  }
  uint32_t pa[4];
  pa[0] = mma::pack_bf16(s0[0], s0[1]);
  pa[1] = mma::pack_bf16(s0[2], s0[3]);
  pa[2] = mma::pack_bf16(s1[0], s1[1]);
  pa[3] = mma::pack_bf16(s1[2], s1[3]);
  mma::mma_16816(st.o[h][0], pa, bv[0], bv[1]);
  mma::mma_16816(st.o[h][1], pa, bv[2], bv[3]);
}

// Keeps the loads of the next head below this point: without it the
// compiler fetches every head's operands first and runs out of registers.
__device__ __forceinline__ void head_fence() {
  asm volatile("" ::: "memory");
}

// One tile of 64 keys from r0 in the team's slot: warp w of the team takes
// keys r0 + 16 w .. + 15.
template <bool kPre>
__device__ __forceinline__ void t2i_tile(State& st, const bf16* slot,
                                         const bf16* q_s, const bf16* w_s,
                                         const float* bk_s, const float* bv_s,
                                         const bf16* __restrict__ pe, int r0,
                                         int n) {
  const int lane = threadIdx.x & 31;
  const int rw = 16 * ((threadIdx.x >> 5) & 3);
  const int g = lane >> 2, t4 = lane & 3;
  const bool tail = r0 + kTile > n;
  const int key0 = r0 + rw + 2 * t4;
  if constexpr (kPre) {
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      uint32_t qa[4], bk[4], bv[4];
      mma::load_a<kI>(qa, q_s, 0, h, lane);
      mma::load_b_nk<kI>(bk, slot, rw, h, lane);
      mma::load_b_kn<kI>(bv, slot + kTile * kI, rw, h, lane);
      attend(st, h, qa, bk, bv, tail, key0, n);
      head_fence();
    }
  } else {
    const int ra = r0 + rw + g, rb = ra + 8;
#pragma unroll
    for (int qr = 0; qr < 4; ++qr) {
      // [64, 64] = keys [64, 256] @ (Wk | Wv)[:, quarter qr]: 16 products of
      // depth 16, both operands read by the tensor cores
      float acc[8][4];
      const uint64_t da = wg::pinned(wg::desc(slot, 16, 1024));
      const uint64_t db = wg::pinned(wg::desc(
          w_s + qr * WBlocks::kBlock, WBlocks::kBlock * 2, 1024));
      wg::fence();
#pragma unroll
      for (int kk = 0; kk < kC / 16; ++kk)
        wg::mma_ss_t<64>(
            acc,
            wg::desc_at(da,
                        2 * ((kk >> 2) * KeyBlocks::kBlock + (kk & 3) * 16)),
            wg::desc_at(db, 2 * kk * 16 * 64), kk > 0);
      wg::commit();
      wg::wait<0>();
      wg::fence_acc(acc);
#pragma unroll
      for (int hl = 0; hl < 2; ++hl) {
        const int h = 2 * qr + hl;
        const int c0 = 16 * h + 2 * t4, c1 = c0 + 8;
        // kk = round(. + pe_k + bk): rows g, g + 8 at dh 2t and 8 + 2t are
        // the B fragments of S as they lie
        const uint32_t* pra = (const uint32_t*)(pe + (long long)ra * kI);
        const uint32_t* prb = (const uint32_t*)(pe + (long long)rb * kI);
        const uint32_t pa0 = ra < n ? __ldg(pra + c0 / 2) : 0u;
        const uint32_t pa1 = ra < n ? __ldg(pra + c1 / 2) : 0u;
        const uint32_t pb0 = rb < n ? __ldg(prb + c0 / 2) : 0u;
        const uint32_t pb1 = rb < n ? __ldg(prb + c1 / 2) : 0u;
        const float(&k0)[4] = acc[2 * hl];
        const float(&k1)[4] = acc[2 * hl + 1];
        uint32_t bk[4];
        bk[0] = mma::pack_bf16(k0[0] + mma::lo_f(pa0) + bk_s[c0],
                               k0[1] + mma::hi_f(pa0) + bk_s[c0 + 1]);
        bk[1] = mma::pack_bf16(k1[0] + mma::lo_f(pa1) + bk_s[c1],
                               k1[1] + mma::hi_f(pa1) + bk_s[c1 + 1]);
        bk[2] = mma::pack_bf16(k0[2] + mma::lo_f(pb0) + bk_s[c0],
                               k0[3] + mma::hi_f(pb0) + bk_s[c0 + 1]);
        bk[3] = mma::pack_bf16(k1[2] + mma::lo_f(pb1) + bk_s[c1],
                               k1[3] + mma::hi_f(pb1) + bk_s[c1 + 1]);
        // vv = round(. + bv), each 8 x 8 block transposed in registers: the
        // B fragments of P V (keys along the depth)
        const float(&v0)[4] = acc[4 + 2 * hl];
        const float(&v1)[4] = acc[5 + 2 * hl];
        const float b00 = bv_s[c0], b01 = bv_s[c0 + 1];
        const float b10 = bv_s[c1], b11 = bv_s[c1 + 1];
        uint32_t bv[4];
        bv[0] = mma::trans8x8(mma::pack_bf16(v0[0] + b00, v0[1] + b01));
        bv[1] = mma::trans8x8(mma::pack_bf16(v0[2] + b00, v0[3] + b01));
        bv[2] = mma::trans8x8(mma::pack_bf16(v1[0] + b10, v1[1] + b11));
        bv[3] = mma::trans8x8(mma::pack_bf16(v1[2] + b10, v1[3] + b11));
        uint32_t qa[4];
        mma::load_a<kI>(qa, q_s, 0, h, lane);
        attend(st, h, qa, bk, bv, tail, key0, n);
        head_fence();
      }
    }
  }
}

// A run's end: the 4 warps' states merge (in warp order) through the
// team's slot into one partial of chain `slot_id`: part_o [16, 128] float
// (tokens < ntok written), part_ml [16, 8] (m, l) float2.
__device__ __forceinline__ void finish_run(State& st, float* o_s, float2* ml_s,
                                           float* __restrict__ part_o,
                                           float2* __restrict__ part_ml,
                                           long long slot_id, int ntok,
                                           int team) {
  const int tt = threadIdx.x % kTeamThreads;
  const int w = tt >> 5, lane = tt & 31;
  const int g = lane >> 2, t4 = lane & 3;
  float* ow = o_s + w * 16 * kI;
#pragma unroll
  for (int h = 0; h < kH; ++h) {
    const float lg = mma::quad_sum(st.l[h][0]);
    const float lh = mma::quad_sum(st.l[h][1]);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const int c = 16 * h + 8 * d + 2 * t4;
      *(float2*)(ow + g * kI + c) = make_float2(st.o[h][d][0], st.o[h][d][1]);
      *(float2*)(ow + (g + 8) * kI + c) =
          make_float2(st.o[h][d][2], st.o[h][d][3]);
    }
    if (t4 == 0) {
      ml_s[(w * 16 + g) * kH + h] = make_float2(st.m[h][0], lg);
      ml_s[(w * 16 + g + 8) * kH + h] = make_float2(st.m[h][1], lh);
    }
  }
  wg::bar_sync(1 + team, kTeamThreads);
  for (int i = tt; i < ntok * (kI / 4); i += kTeamThreads) {
    const int tok = i / (kI / 4), c = (i % (kI / 4)) * 4, h = c / kDh;
    float mx = kNoMax;
#pragma unroll
    for (int v = 0; v < 4; ++v) mx = fmaxf(mx, ml_s[(v * 16 + tok) * kH + h].x);
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float2 ml = ml_s[(v * 16 + tok) * kH + h];
      const float wgt = mma::fast_exp2(ml.x - mx);
      const float4 o = *(const float4*)(o_s + (v * 16 + tok) * kI + c);
      l = fmaf(wgt, ml.y, l);
      acc.x = fmaf(wgt, o.x, acc.x);
      acc.y = fmaf(wgt, o.y, acc.y);
      acc.z = fmaf(wgt, o.z, acc.z);
      acc.w = fmaf(wgt, o.w, acc.w);
    }
    *(float4*)(part_o + (slot_id * 16 + tok) * kI + c) = acc;
    if (c % kDh == 0)
      part_ml[(slot_id * 16 + tok) * kH + h] = make_float2(mx, l);
  }
  wg::bar_sync(1 + team, kTeamThreads);
}

// Block b owns work items [items * b / grid, items * (b + 1) / grid), its
// two teams one half each; item i is run i % runs of chain group i / runs,
// whose chain j is prompt (i / runs) * kNP + j. A team loads a tile into
// its slot, then computes it, while the other team does the same.
template <int kNP, bool kPre>
__global__ void __launch_bounds__(kMmaThreads, 1)
t2i_mma_kernel(const bf16* __restrict__ keys, const bf16* __restrict__ pe,
               const bf16* __restrict__ tok_q, const bf16* __restrict__ wkv,
               const float* __restrict__ bk, const float* __restrict__ bv,
               float* __restrict__ part_o, float2* __restrict__ part_ml,
               int n, int ntok, float scale, long long key_stride,
               long long img_stride, int ppi, int groups, int runs) {
  using L = MmaSmem<kPre>;
  constexpr int S = L::kStages;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  unsigned char* base =
      smem_raw + ((1024u - (mma::smem_addr(smem_raw) & 1023u)) & 1023u);
  bf16* w_s = (bf16*)(base + L::kW);
  float* bk_s = (float*)(base + L::kBias);
  float* bv_s = bk_s + kI;

  const int tid = threadIdx.x;
  const int team = tid / kTeamThreads, tt = tid % kTeamThreads;
  bf16* ring = (bf16*)(base + L::kSlot + team * L::kTeamSlots);
  bf16* q_s = (bf16*)(base + L::kQ + team * L::kQBytes);
  float2* ml_s = (float2*)(base + L::kMl + team * L::kMlBytes);
  const int tiles = (n + kTile - 1) / kTile;
  const int items = groups * runs;
  const int i0 = (int)((long long)items * blockIdx.x / gridDim.x);
  const int i1 = (int)((long long)items * (blockIdx.x + 1) / gridDim.x);
  const int mid = (i0 + i1 + 1) / 2;

  if (!kPre) {
    // Wk | Wv once a block: chunk c of row r (8 columns; block c / 8, its
    // chunk c % 8, of Wk below 4 and of Wv from 4) comes from column
    // (c % 8 < 4 ? 0 : 128) + 32 (c / 8) + 8 (c % 4) of wkv
    for (int i = tid; i < kC * 32; i += kMmaThreads) {
      const int r = i >> 5, c = i & 31;
      const int col = ((c >> 2) & 1) * kI + (c >> 3) * 32 + (c & 3) * 8;
      mma::cp_async16(w_s + WBlocks::off(r, c), wkv + r * 2 * kI + col, true);
    }
    mma::cp_async_commit();
  }
  for (int i = tid; i < kI; i += kMmaThreads) {
    bk_s[i] = bk[i];
    bv_s[i] = bv[i];
  }
  mma::cp_async_wait<0>();
  wg::proxy_fence();
  __syncthreads();

  for (int s = (team ? mid : i0) * kNP; s < (team ? i1 : mid) * kNP; ++s) {
    const int item = s / kNP;
    const int q = item / runs * kNP + s % kNP;
    const int run = item % runs;
    const int t0 = run * kRunTiles, t1 = min(tiles, t0 + kRunTiles);
    const long long img = q / ppi;
    const bf16* kp = keys + q * key_stride + img * img_stride;
    const bf16* vp = pe + img * img_stride;   // under pre: the image's vv
    // the prompt's q, scaled and rounded, tokens >= ntok zero
    for (int i = tt; i < 16 * (kI / 8); i += kTeamThreads) {
      const int row = i / (kI / 8), ch = i % (kI / 8);
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < ntok) {
        v = *(const uint4*)(tok_q + ((long long)q * ntok + row) * kI + ch * 8);
        uint32_t* e = (uint32_t*)&v;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          e[k] = mma::pack_bf16(mma::lo_f(e[k]) * scale,
                                mma::hi_f(e[k]) * scale);
      }
      *(uint4*)(q_s + mma::Tile<kI>::off(row, ch)) = v;
    }
    State st;
#pragma unroll
    for (int h = 0; h < kH; ++h) {
      st.m[h][0] = st.m[h][1] = kNoMax;
      st.l[h][0] = st.l[h][1] = 0.f;
#pragma unroll
      for (int d = 0; d < 2; ++d)
#pragma unroll
        for (int e = 0; e < 4; ++e) st.o[h][d][e] = 0.f;
    }
    // tile k of the run goes to slot k % S; one commit group a tile (an
    // empty one past the run), so that waiting for all but the newest S - 1
    // groups waits for the oldest tile; the tile after each load is asked
    // of L2
    auto load = [&](int tile) {
      if (tile < t1) {
        bf16* dst = ring + (tile - t0) % S * (L::kSlotBytes / 2);
        const int r0 = tile * kTile;
        // the copy's addresses are recomputed at each load, not held
        const int tp = wg::pinned(tt);
        if (kPre) {
          mma::load_rows<kI, kTile, kTeamThreads>(dst, kp, kI, r0, n, kI, tp);
          mma::load_rows<kI, kTile, kTeamThreads>(dst + kTile * kI, vp, kI,
                                                  r0, n, kI, tp);
        } else {
          wg::load_rows<kC, kTile, kTeamThreads>(dst, kp, kC, r0, n, kC, tp);
        }
        if (tt == 0 && tile + 1 < t1) {
          const int nr0 = r0 + kTile, rows = min(kTile, n - nr0);
          if (kPre) {
            wg::prefetch_l2(kp + (long long)nr0 * kI, rows * kI * 2);
            wg::prefetch_l2(vp + (long long)nr0 * kI, rows * kI * 2);
          } else {
            wg::prefetch_l2(kp + (long long)nr0 * kC, rows * kC * 2);
          }
        }
      }
      mma::cp_async_commit();
    };
#pragma unroll
    for (int k = 0; k < S; ++k) load(t0 + k);
    for (int tile = t0; tile < t1; ++tile) {
      mma::cp_async_wait<S - 1>();
      wg::proxy_fence();
      wg::bar_sync(1 + team, kTeamThreads);   // the tile (and q) landed
      t2i_tile<kPre>(st, ring + (tile - t0) % S * (L::kSlotBytes / 2), q_s,
                     w_s, bk_s, bv_s, pe, tile * kTile, n);
      wg::bar_sync(1 + team, kTeamThreads);   // every warp is done with it
      load(tile + S);
    }
    finish_run(st, (float*)ring, ml_s, part_o, part_ml,
               (long long)q * runs + run, ntok, team);
  }
}

// out[p, t] = sum_r w_r O_r / sum_r w_r l_r, w_r = 2^(m_r - max_r m_r), the
// runs taken in key order. One thread per 4 columns of a (prompt, token).
__global__ void __launch_bounds__(256)
t2i_merge_kernel(const float* __restrict__ part_o,
                 const float2* __restrict__ part_ml, bf16* __restrict__ out,
                 int ntok, int runs, long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int c = (int)(idx % (kI / 4)) * 4, h = c / kDh;
  const long long pt = idx / (kI / 4);
  const int tok = (int)(pt % ntok);
  const long long p = pt / ntok;
  float mx = kNoMax;
  for (int r = 0; r < runs; ++r)
    mx = fmaxf(mx, part_ml[((p * runs + r) * 16 + tok) * kH + h].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int r = 0; r < runs; ++r) {
    const long long id = (p * runs + r) * 16 + tok;
    const float2 ml = part_ml[id * kH + h];
    const float wgt = mma::fast_exp2(ml.x - mx);
    const float4 o = *(const float4*)(part_o + id * kI + c);
    l = fmaf(wgt, ml.y, l);
    acc.x = fmaf(wgt, o.x, acc.x);
    acc.y = fmaf(wgt, o.y, acc.y);
    acc.z = fmaf(wgt, o.z, acc.z);
    acc.w = fmaf(wgt, o.w, acc.w);
  }
  const float inv = 1.0f / l;
  uint2 packed;
  packed.x = mma::pack_bf16(acc.x * inv, acc.y * inv);
  packed.y = mma::pack_bf16(acc.z * inv, acc.w * inv);
  *(uint2*)(out + pt * kI + c) = packed;
}

// runs of kRunTiles tiles that cover n keys: the scratch the caller sizes
// for the bf16 kernel holds P * run_count(n) partials
int run_count(int n) {
  return (n + kRunTiles * kTile - 1) / (kRunTiles * kTile);
}

template <int kNP, bool kPre>
int launch_mma(const void* keys, const void* pe, const void* tok_q,
               const void* wkv, const float* bk, const float* bv, void* out,
               void* part_o, void* part_ml, int P, int n, int ntok,
               float scale, long long key_stride, long long img_stride,
               int ppi, cudaStream_t stream) {
  const size_t smem = MmaSmem<kPre>::kLaunch;
  auto kern = t2i_mma_kernel<kNP, kPre>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  const int groups = P / kNP;
  const int runs = run_count(n);
  const long long items = (long long)groups * runs;
  // two teams a block: at most one block an SM, and no idle team
  const long long want = (items + 1) / 2;
  const int grid = (int)(want < sms ? want : sms);
  kern<<<grid, kMmaThreads, smem, stream>>>(
      (const bf16*)keys, (const bf16*)pe, (const bf16*)tok_q,
      (const bf16*)wkv, bk, bv, (float*)part_o, (float2*)part_ml, n, ntok,
      scale, key_stride, img_stride, ppi, groups, runs);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const long long total = (long long)P * ntok * (kI / 4);
  t2i_merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      (const float*)part_o, (const float2*)part_ml, (bf16*)out, ntok, runs,
      total);
  return (int)cudaGetLastError();
}

bool bad_shape(int P, int n, int heads, int ntok, int ppi, int pre,
               int pair) {
  return heads * kDh != kI || ntok < 1 || ntok > 16 || n < 1 || n % 8 ||
         ppi < 1 || (pair && (pre || P % 2));
}

}  // namespace

// tok_q: [P, T, 128]; wkv: [256, 256] = Wk | Wv; bk, bv: float [128]; out:
// [P, T, 128]. Per-prompt keys (pre == 0): keys [P, n, 256], key_stride =
// n * 256, pe [n, 128], img_stride 0. Shared keys (pre != 0): `keys` holds
// kk and `pe` holds vv, both [images, n, 128] with img_stride = n * 128 and
// key_stride 0; prompt q reads image q / ppi. pair != 0 (per-prompt keys
// only, P even): two prompts an item. n % 8 == 0. bf16 takes the
// register-tile kernel, with float32 scratch part_o [P * runs, 16, 128] and
// part_ml [P * runs, 16, 8, 2] for runs = nttt_t2i_runs(n); float32 the
// first port's body (the scratch is not read).
extern "C" int nttt_t2i_runs(int n) { return run_count(n); }

extern "C" int nttt_t2i_attn(const void* keys, const void* pe,
                             const void* tok_q, const void* wkv,
                             const float* bk, const float* bv, void* out,
                             void* part_o, void* part_ml, int P, int n,
                             int heads, int ntok, float scale, int pre,
                             long long key_stride, long long img_stride,
                             int ppi, int pair, int dtype, void* stream) {
  if (bad_shape(P, n, heads, ntok, ppi, pre, pair))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16) {
    if (part_o == nullptr || part_ml == nullptr)
      return (int)cudaErrorInvalidValue;
    if (pre)
      return launch_mma<1, true>(keys, pe, tok_q, wkv, bk, bv, out, part_o,
                                 part_ml, P, n, ntok, scale, key_stride,
                                 img_stride, ppi, s);
    if (pair)
      return launch_mma<2, false>(keys, pe, tok_q, wkv, bk, bv, out, part_o,
                                  part_ml, P, n, ntok, scale, key_stride,
                                  img_stride, ppi, s);
    return launch_mma<1, false>(keys, pe, tok_q, wkv, bk, bv, out, part_o,
                                part_ml, P, n, ntok, scale, key_stride,
                                img_stride, ppi, s);
  }
  return launch_first<float, false>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                                    heads, ntok, scale, pre, key_stride,
                                    img_stride, ppi, pair, s);
}

// The first port's body for either dtype, arguments as `nttt_t2i_attn`
// without the scratch: the parent the bf16 kernel is checked and timed
// against.
extern "C" int nttt_t2i_attn_wmma(const void* keys, const void* pe,
                                  const void* tok_q, const void* wkv,
                                  const float* bk, const float* bv, void* out,
                                  int P, int n, int heads, int ntok,
                                  float scale, int pre, long long key_stride,
                                  long long img_stride, int ppi, int pair,
                                  int dtype, void* stream) {
  if (bad_shape(P, n, heads, ntok, ppi, pre, pair))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return launch_first<__nv_bfloat16, true>(keys, pe, tok_q, wkv, bk, bv,
                                             out, P, n, heads, ntok, scale,
                                             pre, key_stride, img_stride, ppi,
                                             pair, s);
  return launch_first<float, false>(keys, pe, tok_q, wkv, bk, bv, out, P, n,
                                    heads, ntok, scale, pre, key_stride,
                                    img_stride, ppi, pair, s);
}
