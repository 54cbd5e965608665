// The streaming-attention tiles for bf16 operands, with both products on the
// tensor cores and every sum in registers. They serve flash_bh.cu
// (`flash_sdpa`: the Pallas kernels `_onepass_kernel` and `_flash_kernel` of
// no_time_to_train_tpu/ops/flash_attention.py), onepass_attn.cu
// (`flash_sdpa_bnhd`: `_onepass_bnhd_kernel` there), flash_masked.cu
// (`flash_sdpa_masked`: `_flash_masked_kernel`, mode kBias) and
// window_attn.cu (`flash_sdpa_window_qkv`: `_window_qkv_kernel`, mode
// kWindow). float32 operands stay on attn_tile.cuh.
//
// What bounds these calls on the card is the two products (17 GFLOP against
// 8 MB at the memory attention's shape), so the design is about feeding the
// tensor cores. Common to both kernels here:
//  * A warp owns 16 query rows (or two such tiles) at the full head dim. Per
//    key tile of 64 rows the logits S [16, 64], the weights P and the
//    accumulator O [16, DP] live in the accumulator registers of the warp,
//    whose layout the product instructions define (mma_tile.cuh): the
//    online softmax (row maximum, sum, rescale of O) is arithmetic on those
//    registers with two quad shuffles per row, the weights rounded to bf16
//    are the A operand of the second product as they stand, and O meets
//    memory once, at the end.
//  * Shared memory holds operand tiles only: Q once, K and V in rings
//    filled by `cp.async`, swizzled so that the tensor cores' reads are free
//    of bank conflicts.
//  * Where the query tiles alone leave SMs idle (the memory attention: one
//    head, 32 tiles of 128 rows on 132 SMs), the key range is cut into
//    `Split::n` runs of whole key tiles, one block each, which write their
//    unnormalised O, maximum and sum as float32 to scratch; `merge_kernel`
//    combines them in a fixed order, so the result is the same from run to
//    run. The caller picks `n` from (n_q, n_k, D) alone: a batch element's
//    result does not depend on its batch.
// `attn_wg_kernel` issues the products as `wgmma` (wgmma_tile.cuh) and takes
// head dims padded to 64, 128 or 256; `attn_kernel` issues `mma.sync` with
// `ldmatrix` fragments and takes any padded head dim; it serves 80 (Hiera's
// 72), which is not whole 128-byte swizzle atoms.
//
// Arithmetic, as on attn_tile.cuh: float32 logits, the scale folded into the
// base-2 exponent, p = 2^(s * scale_log2 - m) with the unnormalised p rounded
// to bf16 for the product and summed in float32, one division at the end.
// The head dim D is zero-padded to DP in shared memory only (72 runs as 80
// with the scale of 72); keys past the block's range are zero-filled and
// set to -inf before the maximum; rows past n_q are not stored.
//
// Two modes enter where the tail is masked:
//  * kBias (the key-masked attention): a pre-pass hands the kernel, per batch
//    element, the bias of every key in base 2 (0, -1e30 log2(e), and -inf
//    past n_k, padded to whole tiles) and the list of the 64-key tiles that
//    hold a valid key. A block walks the list (count 0: every tile), so a
//    fully masked tile costs neither its bytes nor its products; the key
//    runs of a split are cut over the element's own list. The bias tile
//    rides along with V into a ring of 3 x 64 floats and is added to the
//    base-2 logits, so a masked key of an element with a valid key weighs
//    2^(-1.44e30 - m) = 0 and every real key of an all-masked element gets
//    the same exponent and weighs 1: the mean of v.
//  * kWindow (window attention off a packed qkv): the query rows of a batch
//    element are one flat run, a block takes the next BQ of them whatever
//    windows they lie in, and walks the keys of those windows only. A row
//    sees the keys of its own window [w win, (w + 1) win); a tile that lies
//    inside the window of every row of a warp is not masked at all. On the
//    `mma.sync` kernel each [16, DP] row tile also skips the 16-key groups
//    outside its rows' windows in both products, so a 16-token window costs
//    a quarter of a tile's products.
#pragma once
#include "attn_tile.cuh"
#include "mma_tile.cuh"
#include "wgmma_tile.cuh"

namespace attn_mma {

using attn::Params;
using mma::bf16;
using mma::Tile;

constexpr int kMaxSplits = 4;
// the `mma.sync` kernel: warps of a block, [16, DP] row tiles of a warp, key
// rows of a tile, tiles of the K / V ring
constexpr int kWarps = 4, kRowTiles = 2, kBK = 64, kStages = 3;

// Scratch of the key splits: partial results of (batch, head) slice bh and
// split s at index bh * n + s.
struct Split {
  float* o;       // [B * H * n][n_q][d] unnormalised O
  float2* ml;     // [B * H * n][n_q] maximum (base-2 logits) and sum
  int n;
};

// What a kernel adds to the plain tile (see the head of this file).
constexpr int kPlain = 0, kBias = 1, kWindow = 2;
// the bias ring of kBias: 3 tiles of 64 floats
constexpr int kBiasBytes = 3 * 64 * (int)sizeof(float);
// the bias of a masked key in base 2: -1e30 log2(e)
constexpr float kMaskedLog2 = -1e30f * attn::kLog2e;

// What the pre-pass of kBias leaves per batch element, `tiles` = ceil(n_k /
// 64): the base-2 bias of every key, the taken tiles in ascending order and
// their count (0: no key is valid, every tile is taken).
struct Mask {
  const float* bias2;   // [B][tiles * 64]
  const int* tiles;     // [B][tiles]
  const int* count;     // [B]
};

template <int DP, int MODE = kPlain, int NW = kWarps, int STAGES = kStages>
constexpr int smem_bytes() {
  return (int)sizeof(bf16) * (16 * kRowTiles * NW + 2 * STAGES * kBK) *
             Tile<DP>::kStride +
         (MODE == kBias ? kBiasBytes : 0);
}

// The query tile of a block and the `n_tiles` key tiles it walks: tile i
// starts at key k_lo + i BK, or with a list at key list[i] BK; rows at or
// past k_hi are zero-filled. kPlain with SPLIT: a run [k_lo, k_hi) of whole
// tiles (empty past the key range). kBias: a run of the element's taken
// tiles. kWindow: the windows that the block's BQ query rows lie in.
struct Work {
  int qt, split, k_lo, k_hi, n_tiles;
  const int* list;
};
template <int BK, bool SPLIT, int MODE, int BQ>
__device__ __forceinline__ Work block_work(const Params& P, const Split& S,
                                           const Mask& M) {
  Work w{(int)blockIdx.x, 0, 0, P.n_k, 0, nullptr};
  if (SPLIT) {
    w.qt = blockIdx.x / S.n;
    w.split = blockIdx.x - w.qt * S.n;
  }
  if constexpr (MODE == kBias) {
    const int tiles = (P.n_k + BK - 1) / BK;
    const int count = M.count[blockIdx.z];
    const int taken = count ? count : tiles;
    const int per = SPLIT ? (taken + S.n - 1) / S.n : taken;
    const int first = min(w.split * per, taken);
    w.n_tiles = min(per, taken - first);
    w.k_lo = first * BK;
    if (count) w.list = M.tiles + (long long)blockIdx.z * tiles + first;
  } else if constexpr (MODE == kWindow) {
    const int q0 = w.qt * BQ, q_last = min(q0 + BQ, P.n_q) - 1;
    w.k_lo = q0 / P.win * P.win;
    w.k_hi = (q_last / P.win + 1) * P.win;
    w.n_tiles = (w.k_hi - w.k_lo + BK - 1) / BK;
  } else {
    if (SPLIT) {
      const int tiles = (P.n_k + BK - 1) / BK;
      const int per = (tiles + S.n - 1) / S.n;
      w.k_lo = min(w.split * per * BK, P.n_k);
      w.k_hi = min(w.k_lo + per * BK, P.n_k);
    }
    w.n_tiles = (w.k_hi - w.k_lo + BK - 1) / BK;   // 0: an empty split
  }
  return w;
}
template <int BK, int MODE>
__device__ __forceinline__ int tile_key0(const Work& w, int i) {
  if (MODE == kBias && w.list != nullptr) return __ldg(w.list + i) * BK;
  return w.k_lo + i * BK;
}

// The pieces between the two products, on the accumulator registers of one
// [16, 8 NS] row tile: s[j] is the [16, 8] tile of keys k0 + 8j.., a thread
// holds rows g (values 0, 1) and g + 8 (values 2, 3) at columns 2t, 2t + 1.

// Keys at or past k_hi leave the maximum and the sum.
template <int NS>
__device__ __forceinline__ void mask_tail(float (&s)[NS][4], int k0, int k_hi,
                                          int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int key = k0 + 8 * j + 2 * t;
    if (key >= k_hi) s[j][0] = s[j][2] = -INFINITY;
    if (key + 1 >= k_hi) s[j][1] = s[j][3] = -INFINITY;
  }
}

// kBias: the logits become base-2 logits plus the keys' bias; `bias` holds
// the tile's 64 values in shared memory.
template <int NS>
__device__ __forceinline__ void add_bias(float (&s)[NS][4], const float* bias,
                                         float sl2, int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const float2 b = *(const float2*)(bias + 8 * j + 2 * t);
    s[j][0] = fmaf(s[j][0], sl2, b.x);
    s[j][1] = fmaf(s[j][1], sl2, b.y);
    s[j][2] = fmaf(s[j][2], sl2, b.x);
    s[j][3] = fmaf(s[j][3], sl2, b.y);
  }
}

// kWindow: the key range [lo, hi) of the windows of a thread's two rows of a
// row tile (rows past n_q take the last row's), and of the tile's 16 rows
// together: every row sees [lo_all, hi_all), some row sees [lo_any, hi_any).
struct RowWindows {
  int lo0, hi0, lo1, hi1, lo_all, hi_all, lo_any, hi_any;
};
__device__ __forceinline__ RowWindows row_windows(int row0, int g, int n_q,
                                                  int win) {
  const int first = min(row0, n_q - 1), last = min(row0 + 15, n_q - 1);
  const int w0 = min(row0 + g, n_q - 1) / win * win;
  const int w1 = min(row0 + g + 8, n_q - 1) / win * win;
  const int wf = first / win * win, wl = last / win * win;
  return RowWindows{w0, w0 + win, w1, w1 + win, wl, wf + win, wf, wl + win};
}
// Keys outside a row's window leave its maximum and sum.
template <int NS>
__device__ __forceinline__ void mask_rows(float (&s)[NS][4], int k0,
                                          const RowWindows& r, int t) {
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    const int key = k0 + 8 * j + 2 * t;
    if (key < r.lo0 || key >= r.hi0) s[j][0] = -INFINITY;
    if (key + 1 < r.lo0 || key + 1 >= r.hi0) s[j][1] = -INFINITY;
    if (key < r.lo1 || key >= r.hi1) s[j][2] = -INFINITY;
    if (key + 1 < r.lo1 || key + 1 >= r.hi1) s[j][3] = -INFINITY;
  }
}

// One step of the online softmax: the logits in `s` become the unnormalised
// weights 2^(s * sl2 - m), m the running maximum (base-2 logits) and l this
// lane's share of the running sum; alpha rescales what was summed under the
// old maximum. A row that has seen no key yet keeps p = 0 and alpha = 0.
template <int NS>
__device__ __forceinline__ void softmax_tile(float (&s)[NS][4], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             float sl2) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
    mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
  }
  const float mn0 = fmaxf(m[0], mma::quad_max(mx0) * sl2);
  const float mn1 = fmaxf(m[1], mma::quad_max(mx1) * sl2);
  const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
  const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
  alpha[0] = mma::fast_exp2(m[0] - mu0);
  alpha[1] = mma::fast_exp2(m[1] - mu1);
  float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    s[j][0] = mma::fast_exp2(fmaf(s[j][0], sl2, -mu0));
    s[j][1] = mma::fast_exp2(fmaf(s[j][1], sl2, -mu0));
    s[j][2] = mma::fast_exp2(fmaf(s[j][2], sl2, -mu1));
    s[j][3] = mma::fast_exp2(fmaf(s[j][3], sl2, -mu1));
    sum0 += s[j][0] + s[j][1];
    sum1 += s[j][2] + s[j][3];
  }
  l[0] = l[0] * alpha[0] + sum0;
  l[1] = l[1] * alpha[1] + sum1;
  m[0] = mn0;
  m[1] = mn1;
}

template <int NO>
__device__ __forceinline__ void scale_rows(float (&o)[NO][4],
                                           const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    o[n][0] *= alpha[0];
    o[n][1] *= alpha[0];
    o[n][2] *= alpha[1];
    o[n][3] *= alpha[1];
  }
}

// Two neighbouring tiles of the weights, rounded to bf16, are the A operand
// of keys 16 kk..16 kk + 15 in the second product.
template <int NS>
__device__ __forceinline__ void weights_a(uint32_t (&pa)[4],
                                          const float (&s)[NS][4], int kk) {
  pa[0] = mma::pack_bf16(s[2 * kk][0], s[2 * kk][1]);
  pa[1] = mma::pack_bf16(s[2 * kk][2], s[2 * kk][3]);
  pa[2] = mma::pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
  pa[3] = mma::pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
}

// Rows row0 and row0 + 8 of the result: O / l rounded to bf16, or with SPLIT
// the unnormalised O, maximum and sum of this run to the scratch.
template <int NO, bool SPLIT>
__device__ __forceinline__ void store_rows(const float (&o)[NO][4],
                                           const float (&m)[2],
                                           const float (&l)[2],
                                           const Params& P, const Split& S,
                                           int split, int row0, int t) {
  const int b = blockIdx.z, h = blockIdx.y, row1 = row0 + 8;
  const float l0 = mma::quad_sum(l[0]), l1 = mma::quad_sum(l[1]);
  if (SPLIT) {
    const long long part = (long long)(b * gridDim.y + h) * S.n + split;
    float* og = S.o + part * P.n_q * P.d;
    float2* mlg = S.ml + part * P.n_q;
    if (t == 0) {
      if (row0 < P.n_q) mlg[row0] = make_float2(m[0], l0);
      if (row1 < P.n_q) mlg[row1] = make_float2(m[1], l1);
    }
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < P.d) {
        if (row0 < P.n_q)
          *(float2*)(og + (long long)row0 * P.d + c) =
              make_float2(o[n][0], o[n][1]);
        if (row1 < P.n_q)
          *(float2*)(og + (long long)row1 * P.d + c) =
              make_float2(o[n][2], o[n][3]);
      }
    }
  } else {
    bf16* og = (bf16*)P.o + b * P.o_bs + h * P.o_hs;
    const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int c = 8 * n + 2 * t;
      if (c < P.d) {
        if (row0 < P.n_q)
          *(uint32_t*)(og + (long long)row0 * P.o_rs + c) =
              mma::pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
        if (row1 < P.n_q)
          *(uint32_t*)(og + (long long)row1 * P.o_rs + c) =
              mma::pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
      }
    }
  }
}

// The `mma.sync` kernel: 4 warps of 2 [16, DP] row tiles each, a block of
// 128 query rows; K and V tiles of 64 rows in a ring of 3, in the layout of
// `mma::Tile`. A B fragment fetched by `ldmatrix` serves both row tiles of a
// warp, which halves the shared-memory traffic per product. Every product
// still costs this kernel issue slots and `ldmatrix` bandwidth of its own,
// which is why the head dims that can take `wgmma` do. The window mode runs
// it with 2 warps (a block of 64 rows: one 64-token window, four 16-token
// windows) and a ring of 2, four blocks an SM.
template <int DP, bool SPLIT, int MODE = kPlain, int NW = kWarps,
          int STAGES = kStages>
__global__ void __launch_bounds__(32 * NW) attn_kernel(Params P, Split S,
                                                       Mask M) {
  constexpr int MT = kRowTiles, BK = kBK;
  constexpr int WR = 16 * MT, BQ = WR * NW, THREADS = 32 * NW;
  constexpr int LD = Tile<DP>::kStride;
  // registers of a thread: O DP / 2, S BK / 2, the Q fragments DP / 4 a row
  // tile; Q stays in registers where all of it fits
  constexpr bool kHoistQ = MT * (3 * DP / 4 + BK / 2) <= 184;
  constexpr int KD = DP / 16;     // depth steps of Q K^T
  constexpr int NS = BK / 8;      // accumulator tiles of S
  constexpr int NO = DP / 8;      // accumulator tiles of O
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* q_s = (bf16*)smem_raw;              // [BQ] rows
  bf16* k_s = q_s + BQ * LD;                // [STAGES][BK]
  bf16* v_s = k_s + STAGES * BK * LD;       // [STAGES][BK]
  float* b_s = (float*)(v_s + STAGES * BK * LD);   // kBias: [3][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const Work w = block_work<BK, SPLIT, MODE, BQ>(P, S, M);
  const int q0 = w.qt * BQ, k_hi = w.k_hi, n_tiles = w.n_tiles;
  const bf16* qg = (const bf16*)P.q + b * P.q_bs + h * P.q_hs;
  const bf16* kg = (const bf16*)P.k + b * P.k_bs + h * P.k_hs;
  const bf16* vg = (const bf16*)P.v + b * P.v_bs + h * P.v_hs;

  // zero the pad chunks D/8..DP/8-1 of every tile once: cp.async never
  // writes them
  if (P.d < DP) {
    const int c0 = P.d >> 3, pad = Tile<DP>::kChunks - c0;
    for (int i = tid; i < (BQ + 2 * STAGES * BK) * pad; i += THREADS)
      *(uint4*)(q_s + Tile<DP>::off(i / pad, c0 + i % pad)) =
          make_uint4(0u, 0u, 0u, 0u);
  }

  // tile `tile` of the key range into its stage of the ring; always one
  // commit group, empty past the range
  auto load_kv = [&](int tile) {
    if (tile < n_tiles) {
      const int stage = tile % STAGES, k0 = tile_key0<BK, MODE>(w, tile);
      mma::load_rows<DP, BK, THREADS>(k_s + stage * BK * LD, kg, P.k_rs, k0,
                                      k_hi, P.d);
      mma::load_rows<DP, BK, THREADS>(v_s + stage * BK * LD, vg, P.v_rs, k0,
                                      k_hi, P.d);
      if constexpr (MODE == kBias) {
        if (tid < BK / 4)
          mma::cp_async16(b_s + (tile % 3) * BK + 4 * tid,
                          M.bias2 + ((long long)b * ((P.n_k + BK - 1) / BK)
                                     * BK + k0 + 4 * tid), true);
      }
    }
    mma::cp_async_commit();
  };
  if (n_tiles > 0)
    mma::load_rows<DP, BQ, THREADS>(q_s, qg, P.q_rs, q0, P.n_q, P.d);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) load_kv(i);

  // per row tile: accumulator, running maximum and sum
  float o[MT][NO][4];
  float m_run[MT][2], l_run[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int n = 0; n < NO; ++n)
      o[mt][n][0] = o[mt][n][1] = o[mt][n][2] = o[mt][n][3] = 0.f;
    m_run[mt][0] = m_run[mt][1] = -INFINITY;
    l_run[mt][0] = l_run[mt][1] = 0.f;
  }
  uint32_t qa[MT][kHoistQ ? KD : 1][4];
  [[maybe_unused]] RowWindows rw[MT];
  if constexpr (MODE == kWindow) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
      rw[mt] = row_windows(q0 + warp * WR + 16 * mt, g, P.n_q, P.win);
  }

  for (int it = 0; it < n_tiles; ++it) {
    // tile `it` has landed; every warp is done with tile it - 1, whose stage
    // the next load overwrites
    mma::cp_async_wait<STAGES - 2>();
    __syncthreads();
    load_kv(it + STAGES - 1);
    const bf16* kt = k_s + (it % STAGES) * BK * LD;
    const bf16* vt = v_s + (it % STAGES) * BK * LD;

    if constexpr (kHoistQ) {
      if (it == 0) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int kk = 0; kk < KD; ++kk)
            mma::load_a<DP>(qa[mt][kk], q_s, warp * WR + 16 * mt, kk, lane);
      }
    }

    const int k0 = tile_key0<BK, MODE>(w, it);
    // kWindow: bit np of need[mt] is set where some row of row tile mt sees
    // a key of the tile's 16-key group np; a warp with no such group sits
    // the tile out
    [[maybe_unused]] unsigned need[MT], need_any = 0;
    if constexpr (MODE == kWindow) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        need[mt] = 0;
#pragma unroll
        for (int np = 0; np < BK / 16; ++np)
          if (k0 + 16 * np < rw[mt].hi_any && k0 + 16 * np + 16 > rw[mt].lo_any)
            need[mt] |= 1u << np;
        need_any |= need[mt];
      }
      if (need_any == 0) continue;
    }
    auto wanted = [&](int mt, int group) {
      return MODE != kWindow || ((need[mt] >> group) & 1u);
    };

    // S = Q K^T
    float s[MT][NS][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < NS; ++j)
        s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      if constexpr (!kHoistQ) {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          mma::load_a<DP>(qa[mt][0], q_s, warp * WR + 16 * mt, kk, lane);
      }
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        if (MODE == kWindow && !((need_any >> np) & 1u)) continue;
        uint32_t kb[4];
        mma::load_b_nk<DP>(kb, kt, 16 * np, kk, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!wanted(mt, np)) continue;
          mma::mma_16816(s[mt][2 * np], qa[mt][kHoistQ ? kk : 0], kb[0],
                         kb[1]);
          mma::mma_16816(s[mt][2 * np + 1], qa[mt][kHoistQ ? kk : 0], kb[2],
                         kb[3]);
        }
      }
    }

    bool rescale = false;
    float alpha[MT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      if constexpr (MODE == kBias) {
        add_bias(s[mt], b_s + (it % 3) * BK, P.scale_log2, t);
        softmax_tile(s[mt], m_run[mt], l_run[mt], alpha[mt], 1.f);
      } else {
        if constexpr (MODE == kWindow) {
          if (k0 < rw[mt].lo_all || k0 + BK > rw[mt].hi_all)
            mask_rows(s[mt], k0, rw[mt], t);
        } else {
          if (k0 + BK > k_hi) mask_tail(s[mt], k0, k_hi, t);
        }
        softmax_tile(s[mt], m_run[mt], l_run[mt], alpha[mt], P.scale_log2);
      }
      rescale = rescale || alpha[mt][0] != 1.f || alpha[mt][1] != 1.f;
    }
    if (__any_sync(0xffffffffu, rescale)) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) scale_rows(o[mt], alpha[mt]);
    }

    // O += P V
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      if (MODE == kWindow && !((need_any >> kk) & 1u)) continue;
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) weights_a(pa[mt], s[mt], kk);
#pragma unroll
      for (int np = 0; np < DP / 16; ++np) {
        uint32_t vb[4];
        mma::load_b_kn<DP>(vb, vt, 16 * kk, np, lane);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (!wanted(mt, kk)) continue;
          mma::mma_16816(o[mt][2 * np], pa[mt], vb[0], vb[1]);
          mma::mma_16816(o[mt][2 * np + 1], pa[mt], vb[2], vb[3]);
        }
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    store_rows<NO, SPLIT>(o[mt], m_run[mt], l_run[mt], P, S, w.split,
                          q0 + warp * WR + 16 * mt + g, t);
}

// The same tile on `wgmma` (wgmma_tile.cuh) for head dims padded to 64, 128
// or 256: NWG warpgroups of 64 query rows each, a warp's 16 rows in the
// register layout above. S = Q K^T reads Q and K from shared memory, O += P V
// takes the rounded weights from the accumulator registers and V from shared
// memory. Operand tiles lie in 128-byte-swizzled column blocks; the key tile
// is 64 rows.
//
// The products are asynchronous, and a warpgroup keeps the tensor cores
// busy while it computes the softmax: in iteration i it issues S(i + 1)
// before the softmax of S(i), and O += P V of tile i runs while iteration
// i + 1 starts. So K lives in a ring of 2 tiles (K(i + 1) is read while
// K(i + 2) lands) and V in a ring of 3 (V(i - 1) may still be read while
// V(i) waits and V(i + 1) lands): Q 64 KB + 5 x 32 KB at DP = 256.
template <int DP, int NWG, int MODE = kPlain>
constexpr int wg_smem_bytes() {
  return (int)sizeof(bf16) * (64 * NWG + 5 * 64) * DP + 1024 +
         (MODE == kBias ? kBiasBytes : 0);
}

template <int DP, int NWG, bool SPLIT, int MODE = kPlain>
__global__ void __launch_bounds__(128 * NWG) attn_wg_kernel(Params P, Split S,
                                                            Mask M) {
  constexpr int BK = 64, BQ = 64 * NWG, THREADS = 128 * NWG;
  constexpr int NS = BK / 8, NO = DP / 8;
  using QB = wg::Blocks<DP, BQ>;
  using KB = wg::Blocks<DP, BK>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // the swizzle atoms start on 1024-byte boundaries
  bf16* q_s = (bf16*)(smem_raw + ((1024u - (mma::smem_addr(smem_raw) & 1023u))
                                  & 1023u));
  bf16* k_s = q_s + BQ * DP;                // [2][BK * DP]
  bf16* v_s = k_s + 2 * BK * DP;            // [3][BK * DP]
  float* b_s = (float*)(v_s + 3 * BK * DP);  // kBias: [3][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.y, b = blockIdx.z;
  const Work w = block_work<BK, SPLIT, MODE, BQ>(P, S, M);
  const int q0 = w.qt * BQ, k_hi = w.k_hi, n_tiles = w.n_tiles;
  const bf16* qg = (const bf16*)P.q + b * P.q_bs + h * P.q_hs;
  const bf16* kg = (const bf16*)P.k + b * P.k_bs + h * P.k_hs;
  const bf16* vg = (const bf16*)P.v + b * P.v_bs + h * P.v_hs;

  // cp.async never writes the pad chunks D/8..DP/8-1: zero the tiles once
  if (P.d < DP) {
    for (int i = tid; i < (BQ + 5 * BK) * DP / 8; i += THREADS)
      ((uint4*)q_s)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }

  auto load_k = [&](int tile) {
    if (tile < n_tiles)
      wg::load_rows<DP, BK, THREADS>(k_s + (tile & 1) * BK * DP, kg, P.k_rs,
                                     tile_key0<BK, MODE>(w, tile), k_hi, P.d);
  };
  // with kBias the tile's 64 bias values ride along with V
  auto load_v = [&](int tile) {
    if (tile < n_tiles) {
      const int k0 = tile_key0<BK, MODE>(w, tile);
      wg::load_rows<DP, BK, THREADS>(v_s + (tile % 3) * BK * DP, vg, P.v_rs,
                                     k0, k_hi, P.d);
      if constexpr (MODE == kBias) {
        if (tid < BK / 4)
          mma::cp_async16(b_s + (tile % 3) * BK + 4 * tid,
                          M.bias2 + ((long long)b * ((P.n_k + BK - 1) / BK)
                                     * BK + k0 + 4 * tid), true);
      }
    }
  };
  const bf16* q_w = q_s + (warp >> 2) * 64 * 64;   // this warpgroup's 64 rows
  // S = Q K(tile)^T into `acc`, one product per 16 columns of depth
  auto issue_qk = [&](float (&acc)[NS][4], int tile) {
    const bf16* kt = k_s + (tile & 1) * BK * DP;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const int at = (kk >> 2), in = (kk & 3) * 16;
      wg::mma_ss_n64(acc, wg::desc(q_w + at * QB::kBlock + in, 16, 1024),
                     wg::desc(kt + at * KB::kBlock + in, 16, 1024), kk > 0);
    }
    wg::commit();
  };

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float s[NS][4], s_next[NS][4];
  float m_run[2] = {-INFINITY, -INFINITY}, l_run[2] = {0.f, 0.f};
  [[maybe_unused]] RowWindows rw;
  if constexpr (MODE == kWindow)
    rw = row_windows(q0 + warp * 16, g, P.n_q, P.win);

  if (n_tiles > 0) {
    wg::load_rows<DP, BQ, THREADS>(q_s, qg, P.q_rs, q0, P.n_q, P.d);
    load_k(0);
    load_v(0);
    load_k(1);
    mma::cp_async_commit();
    mma::cp_async_wait<0>();
    wg::proxy_fence();
    __syncthreads();
    issue_qk(s_next, 0);
  }

  for (int it = 0; it < n_tiles; ++it) {
    // S(it) is done (the product behind it, O += P V of tile it - 1, may
    // still run); K(it + 1) and V(it) have landed
    if (it == 0) wg::wait<0>(); else wg::wait<1>();
    wg::fence_acc(s_next);
    mma::cp_async_wait<0>();
    wg::proxy_fence();
    __syncthreads();
    // every warpgroup is done with K(it) and V(it - 2): their stages take
    // K(it + 2) and V(it + 1)
    load_k(it + 2);
    load_v(it + 1);
    mma::cp_async_commit();
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) s[j][i] = s_next[j][i];
    if (it + 1 < n_tiles) issue_qk(s_next, it + 1);

    float alpha[2];
    if constexpr (MODE == kBias) {
      add_bias(s, b_s + (it % 3) * BK, P.scale_log2, t);
      softmax_tile(s, m_run, l_run, alpha, 1.f);
    } else {
      const int k0 = tile_key0<BK, MODE>(w, it);
      if constexpr (MODE == kWindow) {
        if (k0 < rw.lo_all || k0 + BK > rw.hi_all) mask_rows(s, k0, rw, t);
      } else {
        if (k0 + BK > k_hi) mask_tail(s, k0, k_hi, t);
      }
      softmax_tile(s, m_run, l_run, alpha, P.scale_log2);
    }

    // O += P V of tile it - 1 is done (S(it + 1) may still run): its
    // registers, O and the weights, are free again
    if (it + 1 < n_tiles) wg::wait<1>(); else wg::wait<0>();
    wg::fence_acc(o);
    uint32_t pa[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) weights_a(pa[kk], s, kk);
    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
      scale_rows(o, alpha);
    // O += P V, one product per 16 keys
    const bf16* vt = v_s + (it % 3) * BK * DP;
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wg::mma_rs<DP>(o, pa[kk],
                     wg::desc(vt + kk * 16 * 64, KB::kBlock * 2, 1024));
    wg::commit();
  }
  wg::wait<0>();
  wg::fence_acc(o);
  store_rows<NO, SPLIT>(o, m_run, l_run, P, S, w.split, q0 + warp * 16 + g, t);
}

// out = sum_s w_s O_s / sum_s w_s l_s with w_s = 2^(m_s - max_s m_s), the
// splits taken in order; an empty split has m = -inf and weighs 0. One
// thread per 4 columns of a row.
static __global__ void __launch_bounds__(256) merge_kernel(Params P, Split S,
                                                           int heads,
                                                           long long total) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int quads = P.d >> 2;
  const int c = (int)(idx % quads) * 4;
  const long long r = idx / quads;
  const int row = (int)(r % P.n_q);
  const long long bh = r / P.n_q;
  const float2* ml = S.ml + bh * S.n * P.n_q + row;
  float m = -INFINITY;
  for (int s = 0; s < S.n; ++s) m = fmaxf(m, ml[(long long)s * P.n_q].x);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int s = 0; s < S.n; ++s) {
    const float2 v = ml[(long long)s * P.n_q];
    const float w = mma::fast_exp2(v.x - m);
    const float4 part = *(const float4*)(
        S.o + ((bh * S.n + s) * P.n_q + row) * P.d + c);
    l = fmaf(w, v.y, l);
    acc.x = fmaf(w, part.x, acc.x);
    acc.y = fmaf(w, part.y, acc.y);
    acc.z = fmaf(w, part.z, acc.z);
    acc.w = fmaf(w, part.w, acc.w);
  }
  const float inv = 1.0f / l;
  const int b = (int)(bh / heads), h = (int)(bh % heads);
  bf16* og = (bf16*)P.o + b * P.o_bs + h * P.o_hs + (long long)row * P.o_rs + c;
  uint2 packed;
  packed.x = mma::pack_bf16(acc.x * inv, acc.y * inv);
  packed.y = mma::pack_bf16(acc.z * inv, acc.w * inv);
  *(uint2*)og = packed;
}

template <int DP, bool SPLIT, int MODE = kPlain, int NW = kWarps,
          int STAGES = kStages>
int launch_tile(const Params& p, int batch, int heads, const Split& s,
                const Mask& m, cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP, MODE, NW, STAGES>();
  auto kern = attn_kernel<DP, SPLIT, MODE, NW, STAGES>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  constexpr int bq = 16 * kRowTiles * NW;
  const dim3 grid((p.n_q + bq - 1) / bq * s.n, heads, batch);
  kern<<<grid, 32 * NW, smem, stream>>>(p, s, m);
  return (int)cudaGetLastError();
}

static inline int launch_merge(const Params& p, int batch, int heads, const Split& s,
                        cudaStream_t stream) {
  const long long total = (long long)batch * heads * p.n_q * (p.d >> 2);
  merge_kernel<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(
      p, s, heads, total);
  return (int)cudaGetLastError();
}

template <int DP, int MODE = kPlain>
int launch(const Params& p, int batch, int heads, const Split& s,
           const Mask& m, cudaStream_t stream) {
  if (s.n == 1)
    return launch_tile<DP, false, MODE>(p, batch, heads, s, m, stream);
  if (int e = launch_tile<DP, true, MODE>(p, batch, heads, s, m, stream))
    return e;
  return launch_merge(p, batch, heads, s, stream);
}

template <int DP, int NWG, bool SPLIT, int MODE = kPlain>
int launch_wg_tile(const Params& p, int batch, int heads, const Split& s,
                   const Mask& m, cudaStream_t stream) {
  constexpr int smem = wg_smem_bytes<DP, NWG, MODE>();
  auto kern = attn_wg_kernel<DP, NWG, SPLIT, MODE>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int q_tiles = (p.n_q + 64 * NWG - 1) / (64 * NWG);
  const dim3 grid(q_tiles * s.n, heads, batch);
  kern<<<grid, 128 * NWG, smem, stream>>>(p, s, m);
  return (int)cudaGetLastError();
}

template <int DP, int NWG, int MODE = kPlain>
int launch_wg(const Params& p, int batch, int heads, const Split& s,
              const Mask& m, cudaStream_t stream) {
  if (s.n == 1)
    return launch_wg_tile<DP, NWG, false, MODE>(p, batch, heads, s, m, stream);
  if (int e = launch_wg_tile<DP, NWG, true, MODE>(p, batch, heads, s, m,
                                                  stream))
    return e;
  return launch_merge(p, batch, heads, s, stream);
}

// What every entry on these tiles checks: sizes, the grid's limits, the
// scratch of the key splits.
inline bool takes(const Params& p, int batch, int heads, int splits,
                  const void* scratch_o, const void* scratch_ml) {
  return batch >= 1 && heads >= 1 && p.n_q >= 1 && p.n_k >= 1 && p.d >= 8 &&
         p.d <= 256 && p.d % 8 == 0 && batch <= 65535 && heads <= 65535 &&
         splits >= 1 && splits <= kMaxSplits &&
         (splits == 1 || (scratch_o != nullptr && scratch_ml != nullptr));
}

// Plain bf16 attention of `p` (win 0, no bias) over `batch` x `heads` slices
// with the key range in `splits` runs; scratch_o [batch * heads * splits,
// n_q, d] and scratch_ml [batch * heads * splits, n_q, 2] float32 are read
// only with splits > 1. Defined in attn_mma.cu. The key-masked entry
// (flash_masked.cu) and the window entry (window_attn.cu) instantiate their
// own modes of the kernels above.
int run(const Params& p, int batch, int heads, int splits, void* scratch_o,
        void* scratch_ml, void* stream);

}  // namespace attn_mma
