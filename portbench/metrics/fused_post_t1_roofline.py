"""Kernel K4 (`ops/upscale_product.py` `fused_post_t1`,
`csrc/upscale_product.cu`): the decoder's upscaling and hypernetwork
product, as a share of its roofline. The least time of each call is the
larger of its operations over the card's bf16 peak and its bytes (inputs
once, output once) over the memory bandwidth, from the call's operand
shapes (`portbench/counts/common.upscale_call`); the measured time is the
device time of the kernels below launched inside the call."""
from portbench.counts import common

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
KERNELS = ["post_t1_mma_kernel"]


def _work(args, kwargs):
    src = args[0]                      # [prompts, hw, C]
    return common.upscale_call(src.shape[0], src.shape[1], src.shape[2],
                               src.element_size())


RANGES = {"pb.k.fused_post_t1": (
    "function", "no_time_to_train_tpu_torch.models.sam2.mask_decoder",
    "fused_post_t1")}
WORK = {"pb.k.fused_post_t1": _work}


def read(run):
    return run.roofline("pb.k.fused_post_t1", KERNELS)
