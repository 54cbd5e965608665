// The instances of the register-accumulator attention tiles (attn_mma.cuh),
// compiled once for the two entries that use them (flash_bh.cu,
// onepass_attn.cu).
//
// Head dims that pad to 64, 128 or 256 columns (DINO's 64, the memory
// attention's 256) run on the `wgmma` kernel: whole 128-byte swizzle atoms,
// one warpgroup of 64 query rows a block at 64 columns (small blocks even
// out the last wave of DINO's 352), two at 128 and 256. Head dims from 65
// to 80 (Hiera's 72) pad to 80 columns, not whole atoms, and run on the
// `mma.sync` kernel.
#include "attn_mma.cuh"

namespace attn_mma {

int run(const Params& p, int batch, int heads, int splits, void* scratch_o,
        void* scratch_ml, void* stream) {
  if (batch < 1 || heads < 1 || p.n_q < 1 || p.n_k < 1 || p.d < 8 ||
      p.d > 256 || p.d % 8 || batch > 65535 || heads > 65535 || splits < 1 ||
      splits > kMaxSplits || p.win != 0 || p.bias != nullptr ||
      (splits > 1 && (scratch_o == nullptr || scratch_ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Split s{(float*)scratch_o, (float2*)scratch_ml, splits};
  cudaStream_t st = (cudaStream_t)stream;
  if (p.d <= 64) return launch_wg<64, 1>(p, batch, heads, s, st);
  if (p.d <= 80) return launch<80>(p, batch, heads, s, st);
  if (p.d <= 128) return launch_wg<128, 2>(p, batch, heads, s, st);
  return launch_wg<256, 2>(p, batch, heads, s, st);
}

}  // namespace attn_mma
