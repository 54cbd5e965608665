// Tensor-core primitives with known register layouts, for kernels that keep
// their sums in registers: `mma.sync.m16n8k16` on bf16 operands with float32
// accumulation, `ldmatrix` to fetch its operand fragments from shared
// memory, the bank-conflict-free layout of a [rows, DP] bf16 tile, `cp.async`
// row loads into it, and the quad reductions of an accumulator row.
//
// Fragment layouts of one warp (g = lane / 4, t = lane % 4), as PTX defines
// them for m16n8k16:
//   A [16, 16] row-major, 4 registers of 2 bf16:
//     a0 (row g, cols 2t, 2t+1)      a1 (row g+8, cols 2t, 2t+1)
//     a2 (row g, cols 2t+8, 2t+9)    a3 (row g+8, cols 2t+8, 2t+9)
//   B [16, 8] (k, n), 2 registers: b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g)
//   C [16, 8] float32, 4 registers:
//     c0, c1 (row g, cols 2t, 2t+1)  c2, c3 (row g+8, cols 2t, 2t+1)
// so a thread owns two rows (g and g+8) of every accumulator tile, a row's
// values lie in the 4 lanes of a quad, and two neighbouring [16, 8]
// accumulator tiles, rounded to bf16, are the A fragment of the next product
// without leaving the registers.
#pragma once
#include "common.cuh"

namespace mma {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Four 8x8 b16 matrices: lanes 8i..8i+7 give the row addresses of matrix i
// (16-byte aligned); register i of lane l holds matrix i's row l / 4, columns
// 2 (l % 4) and 2 (l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same with every matrix transposed: register i of lane l holds matrix
// i's rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a [16, 16] b [16, 8], bf16 operands, float32 sums.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16, `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The low and high bf16 of a packed pair as floats.
__device__ __forceinline__ float lo_f(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi_f(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// The 8x8 b16 matrix a warp holds one register a lane in the C / A layout
// (lane l: row l / 4, columns 2 (l % 4), + 1), transposed in that layout:
// lane l then holds rows 2 (l % 4), + 1 of column l / 4.
__device__ __forceinline__ uint32_t trans8x8(uint32_t a) {
  uint32_t d;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n"
               : "=r"(d)
               : "r"(a));
  return d;
}

// 2^x on the special-function unit; 2^-inf = 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reductions over the 4 lanes that share an accumulator row.
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A [rows, DP] bf16 tile in shared memory, addressed in 16-byte chunks of 8
// elements. The 8 row addresses of one ldmatrix matrix (8 rows, one chunk
// column) must fall in 8 different 16-byte bank groups. Where a row is a
// multiple of 128 bytes (DP 64, 128, 256) the chunk index is XORed with
// row % 8; otherwise (DP 32, 80) the row stride is padded by one chunk, which
// makes it an odd number of chunks. Tiles stacked at multiples of 8 rows
// share one addressing.
template <int DP>
struct Tile {
  static_assert(DP % 16 == 0, "the depth of a product is 16 elements");
  static constexpr bool kSwizzle = DP % 64 == 0;
  static constexpr int kChunks = DP / 8;
  static constexpr int kStride = kSwizzle ? DP : DP + 8;   // elements
  static __host__ __device__ __forceinline__ int off(int row, int chunk) {
    return row * kStride + ((kSwizzle ? (chunk ^ (row & 7)) : chunk) << 3);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;     // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [r0, r0 + ROWS) of a [*, d] bf16 operand (row stride rs elements, d a
// multiple of 8) into a Tile<DP> of ROWS rows, by THREADS threads (thread
// `tid` of them: threadIdx.x unless given); rows at or past `rows` are
// zero-filled. Chunks d / 8 .. DP / 8 - 1 are not written: a thread whose
// chunk lies there sits the copy out, so that the row and chunk of a thread
// come from divisions by constants.
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rs,
                                          int r0, int rows, int d, int tid) {
  constexpr int kChunks = Tile<DP>::kChunks;
  const int pieces = d >> 3;
#pragma unroll
  for (int i0 = 0; i0 < ROWS * kChunks; i0 += THREADS) {
    const int i = i0 + tid;
    const int r = i / kChunks, c = i % kChunks;
    if ((ROWS * kChunks % THREADS == 0 || r < ROWS) && c < pieces) {
      const bool ok = r0 + r < rows;
      const bf16* s = src + (long long)(ok ? r0 + r : 0) * rs + c * 8;
      cp_async16(dst + Tile<DP>::off(r, c), s, ok);
    }
  }
}
template <int DP, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int rs,
                                          int r0, int rows, int d) {
  load_rows<DP, ROWS, THREADS>(dst, src, rs, r0, rows, d, threadIdx.x);
}

// A fragment of rows [row0, row0 + 16), columns [16 kk, 16 kk + 16) of a
// row-major tile.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, smem_addr(tile + Tile<DP>::off(row0 + (lane & 15),
                                                2 * kk + (lane >> 4))));
}

// B fragments of a product with the tile transposed, S = A T^T: T holds
// [n, k] rows (keys by depth). Rows [n0, n0 + 16), depth [16 kk, 16 kk + 16):
// b[0], b[1] serve the accumulator tile of columns n0..n0+7, b[2], b[3] that
// of n0+8..n0+15.
template <int DP>
__device__ __forceinline__ void load_b_nk(uint32_t (&b)[4], const bf16* tile,
                                          int n0, int kk, int lane) {
  ldmatrix_x4(b, smem_addr(tile + Tile<DP>::off(
                     n0 + ((lane >> 4) << 3) + (lane & 7),
                     2 * kk + ((lane >> 3) & 1))));
}

// B fragments of a product with the tile as it lies, O = P T: T holds [k, n]
// rows (keys by width). Rows [k0, k0 + 16), columns [16 np, 16 np + 16):
// b[0], b[1] serve the accumulator tile of columns 16 np..16 np + 7, b[2],
// b[3] that of 16 np + 8..16 np + 15.
template <int DP>
__device__ __forceinline__ void load_b_kn(uint32_t (&b)[4], const bf16* tile,
                                          int k0, int np, int lane) {
  ldmatrix_x4_trans(b, smem_addr(tile + Tile<DP>::off(
                           k0 + (((lane >> 3) & 1) << 3) + (lane & 7),
                           2 * np + (lane >> 4))));
}

}  // namespace mma
