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
// a block. The mask acts as an additive float32 bias (0 / -1e30) shared by
// the heads, as on the TPU, with the same two properties: a fully masked
// prefix of key tiles is wiped at the first visible key, and a row with
// every key masked returns the uniform mean of v. That mean is taken over
// the n_k real keys, as the plain masked softmax does; the TPU kernel also
// counts the keys it pads to its block size.
//
// Bound: the two products over the valid keys (51.6 GFLOP per object with 3
// of the 7 memory rows valid, 120.5 with the ring full, against 13 to 34 MB
// moved). bf16 operands run on the register-accumulator tiles of
// attn_mma.cuh in mode kBias (`wgmma` at D = 256: 128 query rows a block):
//  * `tile_list_kernel`, a pre-pass of one block per batch element, turns
//    the mask into the keys' bias in base 2 and the ordered list of the
//    64-key tiles that hold a valid key. The attention kernel walks that
//    list, so a masked memory row is neither read nor multiplied. Nothing
//    comes back to the host.
//  * the list is cut into the `splits` runs that the wrapper derives from
//    the shapes alone (4 at this shape: 32 query tiles x 4 = 128 blocks on
//    132 SMs), so the runs share the valid work evenly whatever rows are
//    valid; `merge_kernel` combines them in a fixed order. The grid is
//    sized from the shapes, a run that finds no tile stores an empty
//    partial result, and an element's runs depend on its own mask only.
//  * an element with no valid key takes every tile (count 0), and its rows
//    end as the mean of v.
// float32 operands keep the tile of attn_tile.cuh, which adds the bias row
// per key and walks every tile.
#include "attn_mma.cuh"

namespace {

// One block per batch element. Each warp takes a tile: its lanes write the
// base-2 bias of keys lane and lane + 32 and vote whether one is valid;
// warp 0 then appends the taken tiles of the 32 just seen, in order.
__global__ void __launch_bounds__(1024) tile_list_kernel(
    const unsigned char* valid, int n_k, int tiles, float* bias2, int* list,
    int* count) {
  __shared__ int flag[32];
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned char* vb = valid + (long long)b * n_k;
  float* bb = bias2 + (long long)b * tiles * 64;
  int* lb = list + (long long)b * tiles;
  int taken = 0;                       // warp 0's
  for (int base = 0; base < tiles; base += 32) {
    const int tile = base + warp;
    bool any = false;
    if (tile < tiles) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int key = tile * 64 + lane + 32 * i;
        const bool real = key < n_k;
        const bool ok = real && vb[key] != 0;
        bb[key] = !real ? -INFINITY : ok ? 0.f : attn_mma::kMaskedLog2;
        any = any || ok;
      }
    }
    any = __any_sync(0xffffffffu, any);
    if (lane == 0) flag[warp] = any;
    __syncthreads();
    if (warp == 0) {
      const bool f = flag[lane] != 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (f) lb[taken + __popc(m & ((1u << lane) - 1u))] = base + lane;
      taken += __popc(m);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) count[b] = taken;
}

int fill(attn::Params& p, const long long* strides, int heads, int n_q,
         int n_k, int d, float scale) {
  p.n_q = n_q, p.n_k = n_k, p.d = d, p.win = 0;
  p.scale_log2 = scale * attn::kLog2e;
  return attn::fill_bh(p, strides, heads);
}

}  // namespace

// valid [B, Nk] (one byte a key, 0 = masked) -> bias2 [B, tiles * 64]
// float32, list [B, tiles] int32 (the first count[b] entries are written),
// count [B] int32; tiles = ceil(Nk / 64).
extern "C" int nttt_masked_tile_list(const void* valid, void* bias2,
                                     void* list, void* count, int batch,
                                     int n_k, void* stream) {
  if (batch < 1 || n_k < 1) return (int)cudaErrorInvalidValue;
  tile_list_kernel<<<batch, 1024, 0, (cudaStream_t)stream>>>(
      (const unsigned char*)valid, n_k, (n_k + 63) / 64, (float*)bias2,
      (int*)list, (int*)count);
  return (int)cudaGetLastError();
}

// As nttt_flash_bh, with a key mask per batch element shared by its heads.
// bf16: `valid` [B, Nk] bytes; bias2, list and count are the scratch of
// nttt_masked_tile_list, which this call fills first; the taken tiles run in
// `splits` parts through scratch_o / scratch_ml. float32: `bias` [B, Nk]
// float32 (0 / -1e30) on the tile of attn_tile.cuh, splits = 1.
extern "C" int nttt_flash_masked(const void* q, const void* k, const void* v,
                                 const void* valid, const void* bias,
                                 void* out, const long long* strides,
                                 int batch, int heads, int n_q, int n_k,
                                 int d, float scale, int dtype, int splits,
                                 void* scratch_o, void* scratch_ml,
                                 void* bias2, void* list, void* count,
                                 void* stream) {
  using namespace attn_mma;
  attn::Params p{q, k, v, out, (const float*)bias};
  if (int e = fill(p, strides, heads, n_q, n_k, d, scale)) return e;
  if (dtype != NTTT_DTYPE_BF16) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    return attn::run<true>(p, batch, heads, dtype, stream);
  }
  if (!takes(p, batch, heads, splits, scratch_o, scratch_ml) ||
      valid == nullptr || bias2 == nullptr || list == nullptr ||
      count == nullptr)
    return (int)cudaErrorInvalidValue;
  if (int e = nttt_masked_tile_list(valid, bias2, list, count, batch, n_k,
                                    stream))
    return e;
  const Split s{(float*)scratch_o, (float2*)scratch_ml, splits};
  const Mask m{(const float*)bias2, (const int*)list, (const int*)count};
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 64) return launch_wg<64, 1, kBias>(p, batch, heads, s, m, st);
  if (d <= 80) return launch<80, kBias>(p, batch, heads, s, m, st);
  if (d <= 128) return launch_wg<128, 2, kBias>(p, batch, heads, s, m, st);
  return launch_wg<256, 2, kBias>(p, batch, heads, s, m, st);
}

// The same function on the tile of attn_tile.cuh for either dtype (bias
// [B, Nk] float32): the bf16 kernel this file launched before the mode
// kBias of attn_mma.cuh, kept as a second implementation to check and time
// the new one against.
extern "C" int nttt_flash_masked_wmma(const void* q, const void* k,
                                      const void* v, const void* bias,
                                      void* out, const long long* strides,
                                      int batch, int heads, int n_q, int n_k,
                                      int d, float scale, int dtype,
                                      void* stream) {
  attn::Params p{q, k, v, out, (const float*)bias};
  if (int e = fill(p, strides, heads, n_q, n_k, d, scale)) return e;
  return attn::run<true>(p, batch, heads, dtype, stream);
}
