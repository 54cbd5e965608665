// Single-softmax attention on the [B, N, H, D] layout of a qkv projection:
// DINOv2-L / DINOv3-L layers (1370 / 1374 tokens, 16 heads x 64) and the
// Hiera-L global blocks (4096 tokens, 8 heads x 72).
//
// Replaces the Pallas kernel `_onepass_bnhd_kernel`, reached from
// `flash_sdpa_bnhd` -> `_onepass_bnhd` in
// no_time_to_train_tpu/ops/flash_attention.py. The TPU kernel keeps the
// whole key range in VMEM and takes one softmax over it; on the H100,
// 4096 x 576 bf16 keys and values do not fit a block's shared memory, so one
// block per (batch, head, 64 query rows) streams key tiles with an online
// softmax (attn_tile.cuh).
//
// Bound: at the Hiera global shape a call is 21 GFLOP against 19 MB read, so
// the products bound it; they run on the tensor cores in bf16. q, k and v
// may be strided views of a packed qkv (row strides differ from H * D), so
// the caller never copies them apart.
#include "attn_tile.cuh"

// q [B, Nq, H, D], k / v [B, Nk, H, D] with the given batch and row strides
// (elements; each row's [H, D] block contiguous); out [B, Nq, H, D]
// contiguous. D <= 256, a multiple of 16 bytes; pointers 16-byte aligned.
extern "C" int nttt_onepass_attn(const void* q, const void* k, const void* v,
                                 void* out, long long q_bs, long long k_bs,
                                 long long v_bs, int q_rs, int k_rs, int v_rs,
                                 int b, int n_q, int n_k, int heads, int d,
                                 float scale, int dtype, void* stream) {
  attn::Params p{q, k, v, out, nullptr,
                 q_bs, k_bs, v_bs, (long long)n_q * heads * d,
                 d, d, d, d,
                 q_rs, k_rs, v_rs, heads * d,
                 n_q, n_k, d, 0, scale * attn::kLog2e};
  return attn::run<false>(p, b, heads, dtype, stream);
}
