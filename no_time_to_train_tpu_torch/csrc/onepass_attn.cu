// Single-softmax attention on the [B, N, H, D] layout of a qkv projection:
// DINOv2-L / DINOv3-L layers (1370 / 1374 tokens, 16 heads x 64) and the
// Hiera-L global blocks (4096 tokens, 8 heads x 72).
//
// Replaces the Pallas kernel `_onepass_bnhd_kernel`, reached from
// `flash_sdpa_bnhd` -> `_onepass_bnhd` in
// no_time_to_train_tpu/ops/flash_attention.py. The TPU kernel keeps the
// whole key range in VMEM and takes one softmax over it; on the H100,
// 4096 x 576 bf16 keys and values do not fit a block's shared memory, so one
// block per (batch, head, 64 or 128 query rows) streams key tiles with an
// online softmax.
//
// Bound: at the Hiera global shape a call is 21 GFLOP against 19 MB read, so
// the products bound it. bf16 operands run on the register-accumulator tiles
// of attn_mma.cuh (DINO's D = 64 on `wgmma`, Hiera's 72 padded to 80 on
// `mma.sync`; the softmax on the accumulator registers); 16 or 8 heads give
// 352 or 256 blocks, which fill the card without key splits. float32
// operands keep the tile of attn_tile.cuh. q, k and v may be strided views
// of a packed qkv (row strides differ from H * D), so the caller never
// copies them apart.
#include "attn_mma.cuh"

static attn::Params fill(const void* q, const void* k, const void* v,
                         void* out, long long q_bs, long long k_bs,
                         long long v_bs, int q_rs, int k_rs, int v_rs,
                         int n_q, int n_k, int heads, int d, float scale) {
  return attn::Params{q, k, v, out, nullptr,
                      q_bs, k_bs, v_bs, (long long)n_q * heads * d,
                      d, d, d, d,
                      q_rs, k_rs, v_rs, heads * d,
                      n_q, n_k, d, 0, scale * attn::kLog2e};
}

// q [B, Nq, H, D], k / v [B, Nk, H, D] with the given batch and row strides
// (elements; each row's [H, D] block contiguous); out [B, Nq, H, D]
// contiguous. D <= 256, a multiple of 16 bytes; pointers 16-byte aligned.
// bf16: the key range runs in `splits` parts through the float32 scratch
// (attn_mma.cuh); float32 takes splits = 1.
extern "C" int nttt_onepass_attn(const void* q, const void* k, const void* v,
                                 void* out, long long q_bs, long long k_bs,
                                 long long v_bs, int q_rs, int k_rs, int v_rs,
                                 int b, int n_q, int n_k, int heads, int d,
                                 float scale, int dtype, int splits,
                                 void* scratch_o, void* scratch_ml, void* stream) {
  const attn::Params p = fill(q, k, v, out, q_bs, k_bs, v_bs, q_rs, k_rs,
                              v_rs, n_q, n_k, heads, d, scale);
  if (dtype == NTTT_DTYPE_BF16)
    return attn_mma::run(p, b, heads, splits, scratch_o, scratch_ml,
                         stream);
  if (splits != 1) return (int)cudaErrorInvalidValue;
  return attn::run<false>(p, b, heads, dtype, stream);
}

// The same function on the tile of attn_tile.cuh for either dtype: the bf16
// kernel this file launched before attn_mma.cuh, kept as a second
// implementation to check and time the new tile against.
extern "C" int nttt_onepass_attn_wmma(const void* q, const void* k,
                                      const void* v, void* out,
                                      long long q_bs, long long k_bs,
                                      long long v_bs, int q_rs, int k_rs,
                                      int v_rs, int b, int n_q, int n_k,
                                      int heads, int d, float scale,
                                      int dtype, void* stream) {
  const attn::Params p = fill(q, k, v, out, q_bs, k_bs, v_bs, q_rs, k_rs,
                              v_rs, n_q, n_k, heads, d, scale);
  return attn::run<false>(p, b, heads, dtype, stream);
}
