// One tile of streaming attention, shared by the four attention kernels:
// the single-pass kernel on [B, N, H, D] (onepass_attn.cu), the window
// kernel on a packed qkv (window_attn.cu), and the unmasked and key-masked
// kernels on [B, H, N, D] (flash_bh.cu, flash_masked.cu). It serves their
// float32 operands, and for bf16 operands the `_wmma` entries only: a second
// implementation that the checks hold the tiles of attn_mma.cuh against and
// time them beside. No model's bf16 call lands here.
//
// A block of 4 warps takes 64 query rows of one (batch, head); warp w owns
// rows 16w..16w+15. The block walks its key range in tiles of BK rows,
// double-buffered in shared memory with cp.async, and keeps an online
// softmax: per row the running maximum m and sum l in registers of the two
// lanes that own the row, and the [16, DP] float32 accumulator of each warp
// in shared memory. For each key tile:
//   S = Q K^T                      (bf16: WMMA 16x16x16, float32 sums)
//   t = S * scale * log2(e) + bias * log2(e);  p = exp2(t - m_new)
//   l = l * alpha + sum(p);  O = O * alpha + round(p) V
// and at the end out = O / l, rounded to the storage type. The TPU kernels
// that hold the whole key range on chip normalize before rounding p; here
// the unnormalized p is rounded, a rounding at the same relative size. The
// accumulator rescale is skipped for a warp whose 16 maxima all stayed.
//
// Operands and result are addressed by (batch, head, row) element strides
// with unit stride in D, so [B, N, H, D], [B, H, N, D] and the columns of a
// packed qkv are all read in place.
//
// The head dim D is zero-padded to DP (a multiple of 16, the WMMA depth)
// in shared memory, so D = 72 runs as 80 with the scale of 72. The key tile
// is BK = 64 rows up to DP = 128. At DP = 256 a [64 + 4 * 64, 264] bf16
// tile set plus the float32 accumulators would take 253 KB, more than the
// 227 KB a block may use, so BK is 32 in bf16 (177 KB) and 16 in float32
// (207 KB), and the Q fragments are reloaded from shared memory for every
// key tile instead of living in registers (16 fragments would spill).
//
// Keys past the block's range and query rows past n_q are zero-filled by
// cp.async and masked (keys) or not stored (rows). A key is visible to a row
// when it lies in [lo, hi) of that row: the block's whole range for full
// attention, the row's own window [w * win, (w + 1) * win) for window
// attention. A row that has seen no visible key yet keeps p = 0, alpha = 0.
//
// With BIAS an additive float32 key bias [B, n_k] shared by the heads of a
// batch element (0 = attend, -1e30 = masked) rides along with each key tile
// as 4-byte cp.async copies. logits * scale + bias is taken in float32, so a
// fully masked prefix of tiles (m = -1e30, p = 1) is wiped by
// alpha = exp(-1e30 - m_new) = 0 at the first visible key, and a row whose
// every key is masked ends as the uniform mean of v over the n_k real keys.
//
// Shared memory rows are padded past DP (tiles: 8 elements; logits and
// accumulators: 4 floats) so that the 8 rows a WMMA load or store touches
// fall in different banks; each lane walks its logits starting at its own
// lane index for the same reason. Shared memory (bf16, DP = 80): Q 11 KB,
// K and V 2 x 2 x 11 KB, logits 17 KB (the bf16 weights overwrite them),
// accumulators 21 KB: 94 KB, two blocks on each SM. The float32 variant
// keeps the same tiling with FMAs on the CUDA cores.
#pragma once
#include "common.cuh"

namespace attn {

constexpr int kBQ = 64;           // query rows of a block
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* bias;                 // [B, n_k], read only with BIAS
  long long q_bs, k_bs, v_bs, o_bs;  // batch strides, elements
  long long q_hs, k_hs, v_hs, o_hs;  // head strides, elements
  int q_rs, k_rs, v_rs, o_rs;        // row strides, elements
  int n_q, n_k, d, win;              // win 0: every row sees all n_k keys
  float scale_log2;                  // log2(e) / sqrt(d)
};

// row strides of the Q / K / V tiles (elements), of the accumulators and of
// the logits (floats)
template <int DP>
__host__ __device__ constexpr int ld_tile() { return DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_acc() { return DP + 4; }
template <int BK>
__host__ __device__ constexpr int ld_s() { return BK + 4; }

template <typename T, int DP, int BK>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(kBQ + 4 * BK) * ld_tile<DP>() +
         sizeof(float) * ((size_t)kWarps * 16 * (ld_s<BK>() + ld_acc<DP>()) +
                          2 * BK);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 4 : 0;      // 0: fill the 4 bytes with zeros
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + ROWS) of a [*, D] operand (row stride rs) into a
// [ROWS, DP] tile; rows at or past `rows` are zero-filled.
template <typename T, int DP, int ROWS>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int rs,
                                          int r0, int rows, int d) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = d / kPer;
  for (int i = threadIdx.x; i < ROWS * pieces; i += kThreads) {
    const int r = i / pieces, c = (i % pieces) * kPer;
    const bool ok = r0 + r < rows;
    const T* s = src + (long long)(ok ? r0 + r : 0) * rs + c;
    cp_async16(dst + r * ld_tile<DP>() + c, s, ok);
  }
}

// The block's 64 query rows from q0 against the keys [k_lo, k_hi).
template <typename T, int DP, int BK, bool BIAS>
__device__ void attend_tile(const Params& P, int q0, int k_lo, int k_hi) {
  using namespace nvcuda;
  constexpr int LD = ld_tile<DP>(), LDO = ld_acc<DP>(), LDS = ld_s<BK>();
  constexpr int HALF = BK / 2;      // logits of a row that one lane owns
  // the Q fragments stay in registers across the key loop where they fit
  constexpr bool kHoistQ = DP <= 128;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = (T*)smem_raw;                       // [kBQ][LD]
  T* k_s = q_s + kBQ * LD;                     // [2][BK][LD]
  T* v_s = k_s + 2 * BK * LD;                  // [2][BK][LD]
  float* s_all = (float*)(v_s + 2 * BK * LD);  // [kWarps][16][LDS]
  float* o_all = s_all + kWarps * 16 * LDS;    // [kWarps][16][LDO]
  float* b_s = o_all + kWarps * 16 * LDO;      // [2][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* qg = (const T*)P.q + b * P.q_bs + h * P.q_hs;
  const T* kg = (const T*)P.k + b * P.k_bs + h * P.k_hs;
  const T* vg = (const T*)P.v + b * P.v_bs + h * P.v_hs;
  T* og = (T*)P.o + b * P.o_bs + h * P.o_hs;
  const float* bg = BIAS ? P.bias + (long long)b * P.n_k : nullptr;

  // zero the pad columns D..DP-1 of Q, K and V once (cp.async never writes
  // them) and the accumulators
  if (P.d < DP) {
    const int pad = DP - P.d;
    for (int i = tid; i < (kBQ + 4 * BK) * pad; i += kThreads)
      q_s[(i / pad) * LD + P.d + i % pad] = Num<T>::from_f(0.f);
  }
  float* s_w = s_all + warp * 16 * LDS;
  float* o_w = o_all + warp * 16 * LDO;
  for (int i = lane; i < 16 * LDO; i += 32) o_w[i] = 0.f;

  auto load_kv = [&](int stage, int k0) {
    load_rows<T, DP, BK>(k_s + stage * BK * LD, kg, P.k_rs, k0, k_hi, P.d);
    load_rows<T, DP, BK>(v_s + stage * BK * LD, vg, P.v_rs, k0, k_hi, P.d);
    if (BIAS && tid < BK) {
      const bool ok = k0 + tid < k_hi;
      cp_async4(b_s + stage * BK + tid, bg + (ok ? k0 + tid : 0), ok);
    }
  };

  // the row this lane pair owns, and the keys it may see
  const int r = lane >> 1, half = lane & 1;
  int lo = k_lo, hi = k_hi;
  if (P.win > 0) {
    const int row = min(q0 + warp * 16 + r, P.n_q - 1);
    lo = row / P.win * P.win;
    hi = lo + P.win;
  }
  float m_run = -INFINITY, l_run = 0.f;

  const int n_tiles = (k_hi - k_lo + BK - 1) / BK;
  load_rows<T, DP, kBQ>(q_s, qg, P.q_rs, q0, P.n_q, P.d);
  load_kv(0, k_lo);
  cp_async_commit();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[kHoistQ ? DP / 16 : 1];

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      load_kv((it + 1) & 1, k_lo + (it + 1) * BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = k_s + stage * BK * LD;
    const T* vt = v_s + stage * BK * LD;
    const T* qw = q_s + warp * 16 * LD;
    const float* bt = b_s + stage * BK;

    // S = Q K^T for the warp's 16 rows: [16, BK] float32 in s_w
    if constexpr (Num<T>::is_bf16) {
      if constexpr (kHoistQ) {
        if (it == 0) {
#pragma unroll
          for (int kk = 0; kk < DP / 16; ++kk)
            wmma::load_matrix_sync(qa[kk], (const __nv_bfloat16*)qw + 16 * kk,
                                   LD);
        }
      }
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[BK / 16];
#pragma unroll
      for (int t = 0; t < BK / 16; ++t) wmma::fill_fragment(acc[t], 0.f);
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        if constexpr (!kHoistQ)
          wmma::load_matrix_sync(qa[0], (const __nv_bfloat16*)qw + 16 * kk,
                                 LD);
#pragma unroll
        for (int t = 0; t < BK / 16; ++t) {
          wmma::load_matrix_sync(
              kb, (const __nv_bfloat16*)kt + 16 * t * LD + 16 * kk, LD);
          wmma::mma_sync(acc[t], qa[kHoistQ ? kk : 0], kb, acc[t]);
        }
      }
#pragma unroll
      for (int t = 0; t < BK / 16; ++t)
        wmma::store_matrix_sync(s_w + 16 * t, acc[t], LDS,
                                wmma::mem_row_major);
    } else {
      const float* qr = (const float*)qw + r * LD;
      for (int j = 0; j < HALF; ++j) {
        const float* kr = (const float*)kt + (half * HALF + j) * LD;
        float s = 0.f;
        for (int e = 0; e < DP; ++e) s = fmaf(qr[e], kr[e], s);
        s_w[r * LDS + half * HALF + j] = s;
      }
    }
    __syncwarp();

    // online softmax of row r over this tile's BK keys, HALF per lane:
    // p[j] holds column col(j) of the lane's half, rotated by the lane index
    const int kbase = k_lo + it * BK + half * HALF;
    auto col = [&](int j) { return (j + lane) & (HALF - 1); };
    float p[HALF];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const int c = half * HALF + col(j), key = kbase + col(j);
      float t = s_w[r * LDS + c] * P.scale_log2;
      if (BIAS) t = fmaf(bt[c], kLog2e, t);
      p[j] = (key >= lo && key < hi) ? t : -INFINITY;
      mt = fmaxf(mt, p[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    // a row that has seen no visible key yet keeps p = 0 and alpha = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f(m_run - m_use);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      p[j] = exp2f(p[j] - m_use);
      sum += p[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();                 // every lane has read its logits
    // the weights in the storage type overwrite the logits: row r at the
    // same byte offset, so ldp = LDS * 4 / sizeof(T) elements
    constexpr int kLdp = LDS * (int)(sizeof(float) / sizeof(T));
    T* p_w = (T*)s_w;
#pragma unroll
    for (int j = 0; j < HALF; ++j)
      p_w[r * kLdp + half * HALF + col(j)] = Num<T>::from_f(p[j]);
    // rescale the accumulators, consecutive lanes on consecutive columns;
    // row rr's alpha lives in lane 2 * rr
    if (__any_sync(0xffffffffu, alpha != 1.0f)) {
      for (int i = lane; i < 16 * DP; i += 32) {
        const int rr = i / DP;
        o_w[rr * LDO + i % DP] *= __shfl_sync(0xffffffffu, alpha, 2 * rr);
      }
    }
    __syncwarp();

    // O += P V
    if constexpr (Num<T>::is_bf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa[BK / 16];
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], (const __nv_bfloat16*)p_w + 16 * kk,
                               kLdp);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int t = 0; t < DP / 16; ++t) {
        wmma::load_matrix_sync(acc, o_w + 16 * t, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          wmma::load_matrix_sync(
              vb, (const __nv_bfloat16*)vt + 16 * kk * LD + 16 * t, LD);
          wmma::mma_sync(acc, pa[kk], vb, acc);
        }
        wmma::store_matrix_sync(o_w + 16 * t, acc, LDO, wmma::mem_row_major);
      }
    } else {
      const float* pr = (const float*)p_w + r * kLdp;
      for (int c = half * (DP / 2); c < (half + 1) * (DP / 2); ++c) {
        float u = 0.f;
        for (int j = 0; j < BK; ++j)
          u = fmaf(pr[j], ((const float*)vt)[j * LD + c], u);
        o_w[r * LDO + c] += u;
      }
    }
    __syncthreads();              // the stage is free for the next load
  }

  // out = O / l, consecutive lanes on consecutive columns of a row
  const float inv = 1.0f / l_run;
  for (int i = lane; i < 16 * DP; i += 32) {
    const int rr = i / DP, c = i % DP;
    const float iv = __shfl_sync(0xffffffffu, inv, 2 * rr);
    const int row_out = q0 + warp * 16 + rr;
    if (c < P.d && row_out < P.n_q)
      og[(long long)row_out * P.o_rs + c] =
          Num<T>::from_f(o_w[rr * LDO + c] * iv);
  }
}

// Grid (query tiles, heads, batch). With win > 0 a block reads only the
// keys of the windows its 64 rows lie in.
template <typename T, int DP, int BK, bool BIAS>
__global__ void __launch_bounds__(kThreads) attn_kernel(Params p) {
  const int q0 = blockIdx.x * kBQ;
  int k_lo = 0, k_hi = p.n_k;
  if (p.win > 0) {
    const int q_last = min(q0 + kBQ, p.n_q) - 1;
    k_lo = q0 / p.win * p.win;
    k_hi = (q_last / p.win + 1) * p.win;
  }
  attend_tile<T, DP, BK, BIAS>(p, q0, k_lo, k_hi);
}

template <typename T, int DP, int BK, bool BIAS>
int launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  const int smem = (int)smem_bytes<T, DP, BK>();
  auto kern = attn_kernel<T, DP, BK, BIAS>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((p.n_q + kBQ - 1) / kBQ, heads, batch);
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// D <= 256 runs padded to 32, 64, 80, 128 or 256 columns; the key tile
// shrinks at 256 so that the block's shared memory stays under 227 KB.
template <typename T, bool BIAS>
int dispatch(const Params& p, int batch, int heads, cudaStream_t s) {
  constexpr int kBk256 = Num<T>::is_bf16 ? 32 : 16;
  if (p.d <= 32) return launch<T, 32, 64, BIAS>(p, batch, heads, s);
  if (p.d <= 64) return launch<T, 64, 64, BIAS>(p, batch, heads, s);
  if (p.d <= 80) return launch<T, 80, 64, BIAS>(p, batch, heads, s);
  if (p.d <= 128) return launch<T, 128, 64, BIAS>(p, batch, heads, s);
  return launch<T, 256, kBk256, BIAS>(p, batch, heads, s);
}

// Checks the sizes every entry shares and dispatches on the dtype.
template <bool BIAS>
int run(const Params& p, int batch, int heads, int dtype, void* stream) {
  if (batch < 1 || heads < 1 || p.n_q < 1 || p.n_k < 1 || p.d < 1 ||
      p.d > 256 || batch > 65535 || heads > 65535 ||
      (BIAS && p.bias == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16)
    return dispatch<__nv_bfloat16, BIAS>(p, batch, heads, s);
  return dispatch<float, BIAS>(p, batch, heads, s);
}

// The (batch, head, row) strides of q, k, v in `strides` and a contiguous
// [B, H, n_q, d] result: the layout of flash_bh.cu and flash_masked.cu.
inline int fill_bh(Params& p, const long long* strides, int heads) {
  for (int i = 2; i < 9; i += 3)
    if (strides[i] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  p.q_bs = strides[0], p.k_bs = strides[3], p.v_bs = strides[6];
  p.q_hs = strides[1], p.k_hs = strides[4], p.v_hs = strides[7];
  p.q_rs = (int)strides[2], p.k_rs = (int)strides[5];
  p.v_rs = (int)strides[8];
  p.o_bs = (long long)heads * p.n_q * p.d;
  p.o_hs = (long long)p.n_q * p.d;
  p.o_rs = p.d;
  return 0;
}

}  // namespace attn
