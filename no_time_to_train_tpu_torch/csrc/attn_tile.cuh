// One tile of encoder attention, shared by the single-pass kernel
// (onepass_attn.cu) and the window kernel (window_attn.cu).
//
// A block of 4 warps takes 64 query rows of one (batch, head); warp w owns
// rows 16w..16w+15. The block walks its key range in tiles of 64 rows,
// double-buffered in shared memory with cp.async, and keeps an online
// softmax: per row the running maximum m and sum l in registers of the two
// lanes that own the row, and the [16, DP] float32 accumulator of each warp
// in shared memory. For each key tile:
//   S = Q K^T                      (bf16: WMMA 16x16x16, float32 sums)
//   p = exp((S - m_new) * scale)   (masked keys: p = 0)
//   l = l * alpha + sum(p);  O = O * alpha + round(p) V
// and at the end out = O / l, rounded to the storage type. The TPU kernel
// holds the whole key range on chip and normalizes before rounding p; here
// the unnormalized p is rounded, a rounding at the same relative size.
//
// The head dim D is zero-padded to DP (a multiple of 16, the WMMA depth)
// in shared memory, so D = 72 runs as 80 with the scale of 72. Keys past
// the block's range and query rows past n_q are zero-filled by cp.async and
// masked (keys) or not stored (rows). A key is visible to a row when it
// lies in [lo, hi) of that row: [0, n_k) for full attention, the row's own
// window [w * win, (w + 1) * win) for window attention.
//
// Shared memory rows are padded past DP (tiles: 8 elements; logits and
// accumulators: 4 floats) so that the 8 rows a WMMA load or store touches
// fall in different banks; each lane walks its 32 logits starting at its
// own lane index for the same reason. Shared memory (bf16, DP = 80): Q 11
// KB, K and V 2 x 2 x 11 KB, logits 17 KB (the bf16 weights overwrite
// them), accumulators 21 KB: 93 KB, two blocks on each SM. The float32
// variant keeps the same tiling with FMAs on the CUDA cores.
#pragma once
#include "common.cuh"

namespace attn {

constexpr int kBQ = 64;           // query rows of a block
constexpr int kBK = 64;           // key rows of a tile
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kLdS = kBK + 4;     // row stride of the logits, floats

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_bs, k_bs, v_bs, o_bs;  // batch strides, elements
  int q_rs, k_rs, v_rs, o_rs;        // row strides, elements
  int n_q, n_k, d, win;              // win 0: every row sees all n_k keys
  float scale_log2;                  // log2(e) / sqrt(d)
};

// row strides of the Q / K / V tiles (elements) and of the accumulators
template <int DP>
__host__ __device__ constexpr int ld_tile() { return DP + 8; }
template <int DP>
__host__ __device__ constexpr int ld_acc() { return DP + 4; }

template <typename T, int DP>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)(kBQ + 4 * kBK) * ld_tile<DP>() +
         sizeof(float) * (size_t)kWarps * 16 * (kLdS + ld_acc<DP>());
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows [r0, r0 + 64) of a [*, D] operand (row stride rs) into a [64, DP]
// tile; rows at or past `rows` are zero-filled.
template <typename T, int DP>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int rs,
                                          int r0, int rows, int d) {
  constexpr int kPer = 16 / sizeof(T);
  const int pieces = d / kPer;
  for (int i = threadIdx.x; i < kBK * pieces; i += kThreads) {
    const int r = i / pieces, c = (i % pieces) * kPer;
    const bool ok = r0 + r < rows;
    const T* s = src + (long long)(ok ? r0 + r : 0) * rs + c;
    cp_async16(dst + r * ld_tile<DP>() + c, s, ok);
  }
}

template <typename T, int DP>
__device__ void attend_tile(const Params& P, int q0, int k_lo, int k_hi) {
  using namespace nvcuda;
  constexpr int LD = ld_tile<DP>(), LDO = ld_acc<DP>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  T* q_s = (T*)smem_raw;                       // [kBQ][LD]
  T* k_s = q_s + kBQ * LD;                     // [2][kBK][LD]
  T* v_s = k_s + 2 * kBK * LD;                 // [2][kBK][LD]
  float* s_all = (float*)(v_s + 2 * kBK * LD); // [kWarps][16][kLdS]
  float* o_all = s_all + kWarps * 16 * kLdS;   // [kWarps][16][LDO]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hd = h * P.d;
  const T* qg = (const T*)P.q + b * P.q_bs + hd;
  const T* kg = (const T*)P.k + b * P.k_bs + hd;
  const T* vg = (const T*)P.v + b * P.v_bs + hd;
  T* og = (T*)P.o + b * P.o_bs + hd;

  // zero the pad columns D..DP-1 of Q, K and V once (cp.async never writes
  // them) and the accumulators
  if (P.d < DP) {
    const int pad = DP - P.d;
    for (int i = tid; i < 5 * kBK * pad; i += kThreads)
      q_s[(i / pad) * LD + P.d + i % pad] = Num<T>::from_f(0.f);
  }
  float* s_w = s_all + warp * 16 * kLdS;
  float* o_w = o_all + warp * 16 * LDO;
  for (int i = lane; i < 16 * LDO; i += 32) o_w[i] = 0.f;

  // the row this lane pair owns, and the keys it may see
  const int r = lane >> 1, half = lane & 1;
  const int row = q0 + warp * 16 + r;
  int lo = 0, hi = P.n_k;
  if (P.win > 0) {
    const int re = row < P.n_q ? row : P.n_q - 1;
    lo = re / P.win * P.win;
    hi = lo + P.win;
  }
  float m_run = -INFINITY, l_run = 0.f;

  const int n_tiles = (k_hi - k_lo + kBK - 1) / kBK;
  load_tile<T, DP>(q_s, qg, P.q_rs, q0, P.n_q, P.d);
  load_tile<T, DP>(k_s, kg, P.k_rs, k_lo, k_hi, P.d);
  load_tile<T, DP>(v_s, vg, P.v_rs, k_lo, k_hi, P.d);
  cp_async_commit();

  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>
      qa[DP / 16];

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    if (it + 1 < n_tiles) {
      const int nxt = (it + 1) & 1;
      const int k0 = k_lo + (it + 1) * kBK;
      load_tile<T, DP>(k_s + nxt * kBK * LD, kg, P.k_rs, k0, k_hi, P.d);
      load_tile<T, DP>(v_s + nxt * kBK * LD, vg, P.v_rs, k0, k_hi, P.d);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* kt = k_s + stage * kBK * LD;
    const T* vt = v_s + stage * kBK * LD;
    const T* qw = q_s + warp * 16 * LD;

    // S = Q K^T for the warp's 16 rows: [16, kBK] float32 in s_w
    if constexpr (Num<T>::is_bf16) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wmma::load_matrix_sync(qa[kk], (const __nv_bfloat16*)qw + 16 * kk,
                                 LD);
      }
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::col_major> kb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int t = 0; t < kBK / 16; ++t) {
        wmma::fill_fragment(acc, 0.f);
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          wmma::load_matrix_sync(
              kb, (const __nv_bfloat16*)kt + 16 * t * LD + 16 * kk, LD);
          wmma::mma_sync(acc, qa[kk], kb, acc);
        }
        wmma::store_matrix_sync(s_w + 16 * t, acc, kLdS,
                                wmma::mem_row_major);
      }
    } else {
      const float* qr = (const float*)qw + r * LD;
      for (int j = 0; j < 32; ++j) {
        const float* kr = (const float*)kt + (half * 32 + j) * LD;
        float s = 0.f;
        for (int e = 0; e < DP; ++e) s = fmaf(qr[e], kr[e], s);
        s_w[r * kLdS + half * 32 + j] = s;
      }
    }
    __syncwarp();

    // online softmax of row r over this tile's 64 keys, 32 per lane: p[j]
    // holds column col(j) of the lane's half, rotated by the lane index
    const int kbase = k_lo + it * kBK + half * 32;
    auto col = [&](int j) { return (j + lane) & 31; };
    float p[32];
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int key = kbase + col(j);
      const float s = s_w[r * kLdS + half * 32 + col(j)];
      p[j] = (key >= lo && key < hi) ? s : -INFINITY;
      mt = fmaxf(mt, p[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m_run, mt);
    // a row that has seen no visible key yet keeps p = 0 and alpha = 0
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = exp2f((m_run - m_use) * P.scale_log2);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      p[j] = exp2f((p[j] - m_use) * P.scale_log2);
      sum += p[j];
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_run = l_run * alpha + sum;
    m_run = m_new;
    __syncwarp();                 // every lane has read its logits
    // the weights in the storage type overwrite the logits: row r at the
    // same byte offset, so ldp = kLdS * 4 / sizeof(T) elements
    constexpr int kLdp = kLdS * (int)(sizeof(float) / sizeof(T));
    T* p_w = (T*)s_w;
#pragma unroll
    for (int j = 0; j < 32; ++j)
      p_w[r * kLdp + half * 32 + col(j)] = Num<T>::from_f(p[j]);
    // rescale the accumulators, consecutive lanes on consecutive columns;
    // row rr's alpha lives in lane 2 * rr
    for (int i = lane; i < 16 * DP; i += 32) {
      const int rr = i / DP;
      o_w[rr * LDO + i % DP] *= __shfl_sync(0xffffffffu, alpha, 2 * rr);
    }
    __syncwarp();

    // O += P V
    if constexpr (Num<T>::is_bf16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> pa[kBK / 16];
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk)
        wmma::load_matrix_sync(pa[kk], (const __nv_bfloat16*)p_w + 16 * kk,
                               kLdp);
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> vb;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
#pragma unroll
      for (int t = 0; t < DP / 16; ++t) {
        wmma::load_matrix_sync(acc, o_w + 16 * t, LDO, wmma::mem_row_major);
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
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
        for (int j = 0; j < kBK; ++j)
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

// Set the block's dynamic shared memory and launch `kern` on `grid`.
template <typename T, int DP, typename K>
int launch(K kern, dim3 grid, const Params& p, cudaStream_t stream) {
  const int smem = (int)smem_bytes<T, DP>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kern<<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace attn

// Evaluate CALL, which names DP, at the padded head dim for D: the
// kernels take D <= 128 as DP = 32, 64, 80 or 128.
#define NTTT_ATTN_DISPATCH_DP(D, CALL)               \
  do {                                               \
    if ((D) <= 32) {                                 \
      constexpr int DP = 32;                         \
      return CALL;                                   \
    } else if ((D) <= 64) {                          \
      constexpr int DP = 64;                         \
      return CALL;                                   \
    } else if ((D) <= 80) {                          \
      constexpr int DP = 80;                         \
      return CALL;                                   \
    } else {                                         \
      constexpr int DP = 128;                        \
      return CALL;                                   \
    }                                                \
  } while (0)
