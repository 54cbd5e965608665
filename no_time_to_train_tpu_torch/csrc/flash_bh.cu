// Unmasked attention on [B, H, N, D] operands: the SAM2 memory attention's
// self-attention (q = k [b, 1, 4096, 256], 4 layers per tracked frame) and
// every long unmasked attention that is not in the [B, N, H, D] layout of
// onepass_attn.cu or whose key range is wider than 4608.
//
// Replaces two Pallas kernels of
// no_time_to_train_tpu/ops/flash_attention.py, both reached from
// `flash_sdpa`: `_onepass_kernel` (`_onepass_bh`: the whole key range, at
// most 4608 padded keys, resident in VMEM, one softmax, native D) and
// `_flash_kernel` (`_flash_bh`: online softmax for 4608 < keys <= 12288, D
// lane-padded to 128 with the scale corrected on q). The split at 4608 keys
// and the lane pad are limits of the TPU's VMEM and lanes; here one
// online-softmax kernel over key tiles serves both ranges, with D padded
// only in shared memory.
//
// Bound: at the memory attention's shape a call is 17 GFLOP per object
// against 8 MB moved, so the two products bound it. bf16 operands run on the
// register-accumulator tiles of attn_mma.cuh (`wgmma` products at D = 256,
// the softmax on the accumulator registers, operand tiles alone in shared
// memory); one object is 32 blocks of 128 query rows there, so the wrapper
// cuts the key range into 4 runs (128 blocks on 132 SMs) that a second
// kernel merges. float32 operands keep the tile of attn_tile.cuh (FMAs on
// the CUDA cores): the instance that tells an algorithm bug from rounding.
#include "attn_mma.cuh"

static int fill(attn::Params& p, const long long* strides, int heads, int n_q,
                int n_k, int d, float scale) {
  p.n_q = n_q, p.n_k = n_k, p.d = d, p.win = 0;
  p.scale_log2 = scale * attn::kLog2e;
  return attn::fill_bh(p, strides, heads);
}

// q [B, H, Nq, D], k / v [B, H, Nk, D] with the (batch, head, row) element
// strides in `strides` (unit stride in D, rows 16-byte aligned); out
// [B, H, Nq, D] contiguous. D <= 256 in whole 16-byte pieces. bf16: the key
// range runs in `splits` parts through the float32 scratch (attn_mma.cuh);
// float32 takes splits = 1.
extern "C" int nttt_flash_bh(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int batch,
                             int heads, int n_q, int n_k, int d, float scale,
                             int dtype, int splits, void* scratch_o,
                             void* scratch_ml, void* stream) {
  attn::Params p{q, k, v, out, nullptr};
  if (int e = fill(p, strides, heads, n_q, n_k, d, scale)) return e;
  if (dtype == NTTT_DTYPE_BF16)
    return attn_mma::run(p, batch, heads, splits, scratch_o, scratch_ml,
                         stream);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return attn::run<false>(p, batch, heads, dtype, stream);
}

// The same function on the tile of attn_tile.cuh for either dtype: the bf16
// kernel this file launched before attn_mma.cuh, kept as a second
// implementation to check and time the new tile against.
extern "C" int nttt_flash_bh_wmma(const void* q, const void* k, const void* v,
                                  void* out, const long long* strides,
                                  int batch, int heads, int n_q, int n_k,
                                  int d, float scale, int dtype,
                                  void* stream) {
  attn::Params p{q, k, v, out, nullptr};
  if (int e = fill(p, strides, heads, n_q, n_k, d, scale)) return e;
  return attn::run<false>(p, batch, heads, dtype, stream);
}
