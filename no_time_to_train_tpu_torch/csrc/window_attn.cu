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

namespace {

template <typename T, int DP>
__global__ void __launch_bounds__(attn::kThreads)
window_kernel(attn::Params p) {
  const int q0 = blockIdx.x * attn::kBQ;
  const int q_last = min(q0 + attn::kBQ, p.n_q) - 1;
  const int k_lo = q0 / p.win * p.win;
  const int k_hi = (q_last / p.win + 1) * p.win;
  attn::attend_tile<T, DP>(p, q0, k_lo, k_hi);
}

template <typename T>
int run(const attn::Params& p, int b, int heads, cudaStream_t s) {
  const dim3 grid((p.n_q + attn::kBQ - 1) / attn::kBQ, heads, b);
  NTTT_ATTN_DISPATCH_DP(
      p.d, (attn::launch<T, DP>(window_kernel<T, DP>, grid, p, s)));
}

}  // namespace

// qkv [B, N, 3C] contiguous, N a multiple of win, C = heads * D with
// D <= 128 a multiple of 16 bytes; out [B, N, C].
extern "C" int nttt_window_attn(const void* qkv, void* out, int b, int n,
                                int c, int heads, int win, float scale,
                                int dtype, void* stream) {
  if (b < 1 || n < 1 || heads < 1 || win < 1 || n % win || c % heads ||
      c / heads > 128 || heads > 65535 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int d = c / heads;
  const size_t es = dtype == NTTT_DTYPE_BF16 ? 2 : 4;
  const char* base = (const char*)qkv;
  const long long bs = (long long)n * 3 * c;
  attn::Params p{base, base + es * c, base + es * 2 * c, out,
                 bs, bs, bs, (long long)n * c,
                 3 * c, 3 * c, 3 * c, c,
                 n, n, d, win, scale * 1.4426950408889634f};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == NTTT_DTYPE_BF16) return run<__nv_bfloat16>(p, b, heads, s);
  return run<float>(p, b, heads, s);
}
