// Window-local attention straight off a packed qkv [B, N, 3C]: the Hiera-L
// windowed blocks (stage 1: 1024 windows of 64 tokens, 2 heads x 72;
// stage 2: 1024 x 16, 4 x 72; stage 3: 16 x 256, 8 x 72).
//
// Replaces the Pallas kernel `_window_qkv_kernel`, reached from
// `flash_sdpa_window_qkv` in no_time_to_train_tpu/ops/flash_attention.py.
// Tokens are window-major; each run of `win` tokens attends only within
// itself. The TPU kernel takes several windows per query block and
// separates them with a -1e30 block-diagonal mask; here a block of 64 query
// rows reads only the keys of the windows its rows lie in (one window at
// win = 64, a 64-row slice of one window at 256, four windows under a
// block-diagonal mask at 16) and walks them with attn_tile.cuh. Each head
// reads q, k and v at columns h*D, C + h*D and 2C + h*D of the packed rows
// and writes columns h*D of the [B, N, C] result: no head-split copies.
//
// Bound: about 10 GFLOP a 1024^2 image over the 39 calls, against reading
// the qkv once; the products run on the tensor cores in bf16.
#include "attn_tile.cuh"

// qkv [B, N, 3C] contiguous, N a multiple of win, C = heads * D with
// D <= 256 a multiple of 16 bytes; out [B, N, C].
extern "C" int nttt_window_attn(const void* qkv, void* out, int b, int n,
                                int c, int heads, int win, float scale,
                                int dtype, void* stream) {
  if (n < 1 || heads < 1 || win < 1 || n % win || c % heads)
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t es = dtype == NTTT_DTYPE_BF16 ? 2 : 4;
  const char* base = (const char*)qkv;
  const long long bs = (long long)n * 3 * c;
  attn::Params p{base, base + es * c, base + es * 2 * c, out, nullptr,
                 bs, bs, bs, (long long)n * c,
                 d, d, d, d,
                 3 * c, 3 * c, 3 * c, c,
                 n, n, d, win, scale * attn::kLog2e};
  return attn::run<false>(p, b, heads, dtype, stream);
}
