// W8A8 int8 linear layer of the encoder towers: per-row quantization and
// the int8 product with its scale-and-bias epilogue fused.
//
// Replaces no Pallas kernel: the JAX package computes `int8_dot` and
// `Int8Dense` (no_time_to_train_tpu/ops/quant.py:41-86) with
// `lax.dot_general` on int8 operands, which XLA sends to the MXU. The port
// writes the product by hand because its epilogue decides what the int8
// path costs: a library int8 product writes int32 [M, F] sums that a second
// pass rescales, 4 bytes an element more than a bf16 product writes.
//
// Numerics: those of `int8_dot`, bit for bit. The row scale is absmax / 127
// with IEEE division (0 -> 1), the levels clamp(rint(x / s), -127, 127) with
// ties to even, the sums int32 (exact in any order), the epilogue
// (float(acc) * xs) * ks + bias in float32, rounded once to the output type.
// Every float step is spelled with an _rn intrinsic: nvcc contracts a * b + c
// into an FMA by default, which would round once where the plain version
// rounds twice.
//
// quant_rows_kernel: one warp a row of a [rows, cols] float32 or bf16
// operand (the activations, and the [F, C] weight, whose rows are its output
// channels). It writes the levels [rows, ld] with the columns cols..ld-1 zero
// (ld a multiple of 16, so the product's 16-byte loads never straddle a row)
// and the scales [rows] float32. Bound by bytes: the row read, one byte an
// element written.
//
// int8_gemm_kernel: out [M, F] from xq [M, K] and wq [F, K] (K a multiple of
// 16), the `row.col` operands of mma.sync.m16n8k32.s32.s8.s8.s32 as they lie.
// A block of 8 warps computes a 128 x 128 tile, a warp 64 x 32 (4 x 4
// accumulator tiles); K advances 64 bytes a step through a two-stage
// cp.async ring in shared memory whose rows are padded to 80 bytes, so the
// 32-bit fragment loads of a warp fall on 32 different banks. Rows past M or
// F and the K tail load as zeros (cp.async with a source size of 0). Bound at
// the slice's shapes: operations at 1979 TOPS for the large products, bytes
// at Hiera-L's stage 1 (K 144). A simple tile: wgmma on s8 and TMA loads are
// later work.
#include "common.cuh"
#include "mma_tile.cuh"

namespace {

constexpr int kRowsPerBlock = 8;      // quant_rows: a warp a row
constexpr int kBM = 128, kBN = 128;   // product tile
constexpr int kBK = 64;               // bytes of K a stage
constexpr int kStride = kBK + 16;     // shared-memory row, bytes
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kRowsPerBlock * 32)
quant_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                  float* __restrict__ scales, int rows, int cols, int ld) {
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const T* xr = x + (size_t)row * cols;
  float amax = 0.f;
  for (int c = lane; c < cols; c += 32)
    amax = fmaxf(amax, fabsf(Num<T>::to_f(xr[c])));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  float s = __fdiv_rn(amax, 127.0f);
  if (s == 0.f) s = 1.f;            // an all-zero row: levels 0, not 0 / 0
  int8_t* qr = q + (size_t)row * ld;
  for (int c = lane; c < ld; c += 32) {
    float v = 0.f;
    if (c < cols)
      v = fminf(fmaxf(rintf(__fdiv_rn(Num<T>::to_f(xr[c]), s)), -127.f),
                127.f);
    qr[c] = (int8_t)__float2int_rn(v);
  }
  if (lane == 0) scales[row] = s;
}

// c += a [16, 32] b [32, 8], int8 operands, int32 sums.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Bytes k0 .. k0 + 63 of rows r0 .. r0 + 127 of a [rows, K] int8 operand
// into a [128, kStride] slab: 512 pieces of 16 bytes, 2 a thread.
__device__ __forceinline__ void load_slab(int8_t* dst,
                                          const int8_t* __restrict__ src,
                                          int rows, int K, int r0, int k0,
                                          int tid) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 2, piece = idx & 3;
    const int gr = r0 + r, gk = k0 + 16 * piece;
    const bool ok = gr < rows && gk < K;
    mma::cp_async16(dst + r * kStride + 16 * piece,
                    ok ? src + (size_t)gr * K + gk : src, ok);
  }
}

__device__ __forceinline__ uint32_t lds32(const int8_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename TO>
__global__ void __launch_bounds__(kThreads)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ wq,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 const float* __restrict__ bias, TO* __restrict__ out, int M,
                 int F, int K) {
  __shared__ __align__(16) int8_t As[2][kBM * kStride];
  __shared__ __align__(16) int8_t Bs[2][kBN * kStride];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;   // 2 x 4 warps
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int nk = (K + kBK - 1) / kBK;
  load_slab(As[0], xq, M, K, m0, 0, tid);
  load_slab(Bs[0], wq, F, K, n0, 0, tid);
  mma::cp_async_commit();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_slab(As[cur ^ 1], xq, M, K, m0, (kt + 1) * kBK, tid);
      load_slab(Bs[cur ^ 1], wq, F, K, n0, (kt + 1) * kBK, tid);
    }
    mma::cp_async_commit();
    mma::cp_async_wait<1>();          // stage kt has landed
    __syncthreads();
    const int8_t* a_s = As[cur] + (wm * 64 + g) * kStride + 4 * t;
    const int8_t* b_s = Bs[cur] + (wn * 32 + g) * kStride + 4 * t;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      // A (row g / g + 8, bytes 4t.. and 16 + 4t..), B (row n = g, the same
      // bytes of k): the m16n8k32 s8 fragments, one 32-bit load each
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = a_s + i * 16 * kStride + ks;
        a[i][0] = lds32(p);
        a[i][1] = lds32(p + 8 * kStride);
        a[i][2] = lds32(p + 16);
        a[i][3] = lds32(p + 8 * kStride + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = b_s + j * 8 * kStride + ks;
        b[j][0] = lds32(p);
        b[j][1] = lds32(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();                  // the slab is free for stage kt + 2
  }

  // accumulator register 2h + e of tile (i, j): row g + 8h, column 2t + e
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + wm * 64 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
      TO* orow = out + (size_t)m * F;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int f = n0 + wn * 32 + j * 8 + 2 * t + e;
          if (f >= F) continue;
          float v = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]),
                                        sx), ws[f]);
          if (bias != nullptr) v = __fadd_rn(v, bias[f]);
          orow[f] = Num<TO>::from_f(v);
        }
      }
    }
  }
}

}  // namespace

// x [rows, cols] (dtype: 0 float32, 1 bf16) -> q [rows, ld] int8 (columns
// cols..ld-1 zero), scales [rows] float32.
extern "C" int nttt_quant_rows(const void* x, void* q, void* scales, int rows,
                               int cols, int ld, int dtype, void* stream) {
  if (rows < 1 || cols < 1 || ld < cols || ld % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (dtype == NTTT_DTYPE_BF16)
    quant_rows_kernel<__nv_bfloat16><<<blocks, kRowsPerBlock * 32, 0, s>>>(
        (const __nv_bfloat16*)x, (int8_t*)q, (float*)scales, rows, cols, ld);
  else
    quant_rows_kernel<float><<<blocks, kRowsPerBlock * 32, 0, s>>>(
        (const float*)x, (int8_t*)q, (float*)scales, rows, cols, ld);
  return (int)cudaGetLastError();
}

// out [m, f] (out_dtype: 0 float32, 1 bf16) = (float(xq . wq^T) * xs) * ws
// + bias; xq [m, k], wq [f, k] int8 with k a multiple of 16; xs [m], ws [f],
// bias [f] float32, bias may be null.
extern "C" int nttt_int8_gemm(const void* xq, const void* wq, const void* xs,
                              const void* ws, const void* bias, void* out,
                              int m, int f, int k, int out_dtype,
                              void* stream) {
  if (m < 1 || f < 1 || k < 16 || k % 16 || (m + kBM - 1) / kBM > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((f + kBN - 1) / kBN, (m + kBM - 1) / kBM);
  if (out_dtype == NTTT_DTYPE_BF16)
    int8_gemm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const int8_t*)xq, (const int8_t*)wq, (const float*)xs,
        (const float*)ws, (const float*)bias, (__nv_bfloat16*)out, m, f, k);
  else
    int8_gemm_kernel<float><<<grid, kThreads, 0, s>>>(
        (const int8_t*)xq, (const int8_t*)wq, (const float*)xs,
        (const float*)ws, (const float*)bias, (float*)out, m, f, k);
  return (int)cudaGetLastError();
}
