// Window-local attention straight off a packed qkv [B, N, 3C]: the Hiera-L
// windowed blocks (stage 1: 1024 windows of 64 tokens, 2 heads x 72;
// stage 2: 1024 x 16, 4 x 72; stage 3: 16 x 256, 8 x 72), at a batch of two
// also its global blocks as two "windows" of 4096 tokens, and the 196- and
// 49-token windows of the smaller topologies.
//
// Replaces the Pallas kernel `_window_qkv_kernel`, reached from
// `flash_sdpa_window_qkv` in no_time_to_train_tpu/ops/flash_attention.py.
// Tokens are window-major; each run of `win` tokens attends only within
// itself. The TPU kernel takes several windows per query block and
// separates them with a -1e30 block-diagonal mask. Each head reads q, k and
// v at columns h*D, C + h*D and 2C + h*D of the packed rows and writes
// columns h*D of the [B, N, C] result: no head-split copies.
//
// Bound: at 4096- and 256-token windows the two products (42 GFLOP for two
// global blocks); at 64- and 16-token windows the bytes (75.5 MB at stage
// 1: the packed qkv read once, the result written once). bf16 operands run
// on the register-accumulator tiles of attn_mma.cuh:
//  * a window of whole 128-row blocks (256, 4096) is a batch element of the
//    plain kernels: q, k and v of window w start at row w * win of the
//    packed rows. At D = 72 this is, instance for instance, what
//    `flash_sdpa_bnhd` runs on one image's global block, so a window's
//    result equals that kernel's on the same rows bit for bit.
//  * any other window runs in mode kWindow: a block takes the next 64 query
//    rows of the flat token run, whatever windows they lie in, reads the
//    keys of those windows once, and masks per row; at D = 72 (`mma.sync`,
//    2 warps, four blocks an SM to keep bytes in flight) a row tile only
//    multiplies the 16-key groups its rows can see. No block idles over
//    rows that are not there, whatever `win` is.
// float32 operands keep the tile of attn_tile.cuh.
#include "attn_mma.cuh"

namespace {

attn::Params fill(const void* qkv, void* out, int n, int c, int heads,
                  int win, float scale, int dtype) {
  const int d = c / heads;
  const size_t es = dtype == NTTT_DTYPE_BF16 ? 2 : 4;
  const char* base = (const char*)qkv;
  const long long bs = (long long)n * 3 * c;
  return attn::Params{base, base + es * c, base + es * 2 * c, out, nullptr,
                      bs, bs, bs, (long long)n * c,
                      d, d, d, d,
                      3 * c, 3 * c, 3 * c, c,
                      n, n, d, win, scale * attn::kLog2e};
}

bool sizes_ok(int n, int c, int heads, int win) {
  return n >= 1 && heads >= 1 && win >= 1 && n % win == 0 && c % heads == 0;
}

}  // namespace

// qkv [B, N, 3C] contiguous, N a multiple of win, C = heads * D with
// D <= 256 a multiple of 16 bytes; out [B, N, C].
extern "C" int nttt_window_attn(const void* qkv, void* out, int b, int n,
                                int c, int heads, int win, float scale,
                                int dtype, void* stream) {
  using namespace attn_mma;
  if (!sizes_ok(n, c, heads, win)) return (int)cudaErrorInvalidValue;
  attn::Params p = fill(qkv, out, n, c, heads, win, scale, dtype);
  if (dtype != NTTT_DTYPE_BF16)
    return attn::run<false>(p, b, heads, dtype, stream);
  const long long windows = (long long)b * (n / win);
  if (win % 128 == 0 && windows <= 65535) {
    // window w of batch element i is batch element i * (n / win) + w
    p.q_bs = p.k_bs = p.v_bs = (long long)win * 3 * c;
    p.o_bs = (long long)win * c;
    p.n_q = p.n_k = win;
    p.win = 0;
    return run(p, (int)windows, heads, 1, nullptr, nullptr, stream);
  }
  if (!takes(p, b, heads, 1, nullptr, nullptr))
    return (int)cudaErrorInvalidValue;
  const Split s{nullptr, nullptr, 1};
  const Mask none{nullptr, nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  const int d = p.d;
  if (d <= 64)
    return launch_wg_tile<64, 1, false, kWindow>(p, b, heads, s, none, st);
  if (d <= 80)
    return launch_tile<80, false, kWindow, 2, 2>(p, b, heads, s, none, st);
  if (d <= 128)
    return launch_wg_tile<128, 1, false, kWindow>(p, b, heads, s, none, st);
  return launch_wg_tile<256, 1, false, kWindow>(p, b, heads, s, none, st);
}

// The same function on the tile of attn_tile.cuh for either dtype: the bf16
// kernel this file launched before attn_mma.cuh took it, kept as a second
// implementation to check and time the new one against.
extern "C" int nttt_window_attn_wmma(const void* qkv, void* out, int b, int n,
                                     int c, int heads, int win, float scale,
                                     int dtype, void* stream) {
  if (!sizes_ok(n, c, heads, win)) return (int)cudaErrorInvalidValue;
  const attn::Params p = fill(qkv, out, n, c, heads, win, scale, dtype);
  return attn::run<false>(p, b, heads, dtype, stream);
}
