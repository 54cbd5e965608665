"""Kernel 9 (`ops/flash_attention.py` `flash_sdpa_bnhd`,
`csrc/onepass_attn.cu` on the tiles of `csrc/attn_mma.cuh`) as a share of
its roofline: DINOv3-7B's 40 calls a request at [1, 1374, 32, 128] and
Hiera-L's 3 global blocks at [1, 4096, 8, 72]. The least time of each call
is the larger of its operations (both products at the real head dim) over
the card's bf16 peak and its bytes (q, k, v read once, the output written
once); the calls are one request's, enumerated from the configuration
(`portbench/counts/sam2l_dinov3_7b.attn_calls`, each as `attn_call` gives
it), times the requests of the traced segment. The measured time is the
device time of kernel 9's launches, by name and grid
(`portbench/harness/kernels.bnhd`: kernel 10's launches on the same tile
run several windows a launch), inside the encoders' forwards (`pb.dinov3`,
`pb.hiera`), which a CUDA graph replayed inside them keeps. The wrapper on
the Python function counts the calls that eager code makes, for the run's
notes only."""
from portbench.counts import sam2l_dinov3_7b as counts
from portbench.harness import kernels

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]


def _work(args, kwargs):
    q, k = args[0], args[1]             # [B, N, heads, D]
    b, nq, heads, d = q.shape
    return counts.attn_call(b, nq, k.shape[1], heads, d, q.element_size())


RANGES = {"pb.dinov3": ("module", "dino"),
          "pb.hiera": ("module", "sam2.image_encoder"),
          **counts.present({"pb.k.flash_sdpa_bnhd": (
              "function", "no_time_to_train_tpu_torch.ops.attention",
              "flash_sdpa_bnhd")})}
WORK = {"pb.k.flash_sdpa_bnhd": _work}


def read(run):
    return run.kernel_share("dinov3.flash_sdpa_bnhd_roofline",
                            ["pb.dinov3", "pb.hiera"], kernels.bnhd,
                            counts.attn_calls, seen="pb.k.flash_sdpa_bnhd")
