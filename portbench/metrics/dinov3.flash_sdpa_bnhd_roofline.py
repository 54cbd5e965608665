"""Kernel 9 (`ops/flash_attention.py` `flash_sdpa_bnhd`,
`csrc/onepass_attn.cu` on the tiles of `csrc/attn_mma.cuh`) as a share of
its roofline: DINOv3-7B's 40 calls a request at [1, 1374, 32, 128] and
Hiera-L's 3 global blocks at [1, 4096, 8, 72]. The least time of each call
is the larger of its operations (both products at the real head dim) over
the card's bf16 peak and its bytes (q, k, v read once, the output written
once) over the memory bandwidth, from the call's operand shapes
(`portbench/counts/sam2l_dinov3_7b.attn_call`); the measured time is the
device time of the attention kernels launched inside the call."""
from portbench.counts import sam2l_dinov3_7b as counts

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
KERNELS = ["attn_mma::attn_kernel", "attn_mma::attn_wg_kernel",
           "attn_mma::merge_kernel"]


def _work(args, kwargs):
    q, k = args[0], args[1]             # [B, N, heads, D]
    b, nq, heads, d = q.shape
    return counts.attn_call(b, nq, k.shape[1], heads, d, q.element_size())


RANGES = counts.present({"pb.k.flash_sdpa_bnhd": (
    "function", "no_time_to_train_tpu_torch.ops.attention",
    "flash_sdpa_bnhd")})
WORK = {"pb.k.flash_sdpa_bnhd": _work}


def read(run):
    return run.roofline("pb.k.flash_sdpa_bnhd", KERNELS)
