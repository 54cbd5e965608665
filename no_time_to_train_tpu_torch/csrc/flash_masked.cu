// Streaming attention with a per-batch key-column mask: the SAM2 memory
// attention's cross-attention, 4096 image queries against the memory bank
// (7 maskmem rows x 4096 tokens + 16 object pointers x 4 tokens = 28736
// keys, D = 256, one head), whose valid rows change with the ring's fill.
//
// Replaces the Pallas kernel `_flash_masked_kernel`, reached from
// `flash_sdpa_masked` -> `_flash_masked_bh` in
// no_time_to_train_tpu/ops/flash_attention.py. The TPU kernel walks the key
// blocks on its sequential innermost grid dimension and carries the online
// softmax in VMEM scratch between grid steps; here the key loop runs inside
// a block (attn_tile.cuh). The mask arrives as an additive float32 bias row
// (0 / -1e30) shared by the heads, as on the TPU, with the same two
// properties: a fully masked prefix of key tiles is wiped at the first
// visible key, and a row with every key masked returns the uniform mean of
// v. That mean is taken over the n_k real keys, as the plain masked softmax
// does; the TPU kernel also counts the keys it pads to its block size.
//
// Bound: 120 GFLOP per object and call against 34 MB moved, so the two
// products bound it; they run on the tensor cores in bf16 (WMMA) with
// 32-key tiles at D = 256. One block per 64 query rows gives 64 blocks per
// object, half of the card's 132 SMs at one object.
#include "attn_tile.cuh"

// As nttt_flash_bh, plus bias [B, Nk] float32 contiguous, added to the
// scaled logits of every head of a batch element.
extern "C" int nttt_flash_masked(const void* q, const void* k, const void* v,
                                 const void* bias, void* out,
                                 const long long* strides, int batch,
                                 int heads, int n_q, int n_k, int d,
                                 float scale, int dtype, void* stream) {
  attn::Params p{q, k, v, out, (const float*)bias};
  p.n_q = n_q, p.n_k = n_k, p.d = d, p.win = 0;
  p.scale_log2 = scale * attn::kLog2e;
  if (int e = attn::fill_bh(p, strides, heads)) return e;
  return attn::run<true>(p, batch, heads, dtype, stream);
}
