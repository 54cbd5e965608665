// The plain instances of the register-accumulator attention tiles
// (attn_mma.cuh), compiled once for the entries that use them (flash_bh.cu,
// onepass_attn.cu, and window_attn.cu for windows of whole 128-row blocks).
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
  if (!takes(p, batch, heads, splits, scratch_o, scratch_ml) || p.win != 0 ||
      p.bias != nullptr)
    return (int)cudaErrorInvalidValue;
  const Split s{(float*)scratch_o, (float2*)scratch_ml, splits};
  const Mask none{nullptr, nullptr, nullptr};
  cudaStream_t st = (cudaStream_t)stream;
  if (p.d <= 64) return launch_wg<64, 1>(p, batch, heads, s, none, st);
  if (p.d <= 80) return launch<80>(p, batch, heads, s, none, st);
  if (p.d <= 128) return launch_wg<128, 2>(p, batch, heads, s, none, st);
  return launch_wg<256, 2>(p, batch, heads, s, none, st);
}

}  // namespace attn_mma
