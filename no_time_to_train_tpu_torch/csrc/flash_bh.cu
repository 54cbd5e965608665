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
// online-softmax kernel over key tiles (attn_tile.cuh) serves both ranges,
// with D padded only in shared memory.
//
// Bound: at the memory attention's shape a call is 17 GFLOP per object
// against 8 MB moved, so the two products bound it; they run on the tensor
// cores in bf16 (WMMA), with 64 blocks per object.
#include "attn_tile.cuh"

// q [B, H, Nq, D], k / v [B, H, Nk, D] with the (batch, head, row) element
// strides in `strides` (unit stride in D, rows 16-byte aligned); out
// [B, H, Nq, D] contiguous. D <= 256 in whole 16-byte pieces.
extern "C" int nttt_flash_bh(const void* q, const void* k, const void* v,
                             void* out, const long long* strides, int batch,
                             int heads, int n_q, int n_k, int d, float scale,
                             int dtype, void* stream) {
  attn::Params p{q, k, v, out, nullptr};
  p.n_q = n_q, p.n_k = n_k, p.d = d, p.win = 0;
  p.scale_log2 = scale * attn::kLog2e;
  if (int e = attn::fill_bh(p, strides, heads)) return e;
  return attn::run<false>(p, batch, heads, dtype, stream);
}
