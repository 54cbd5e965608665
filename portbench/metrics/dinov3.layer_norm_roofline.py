"""Kernel K1 (`ops/fused_ln.py` `layer_norm`, `csrc/layer_norm.cu`: the
wide-row kernel at C 4096) on DINOv3's 81 LayerNorms a request
(`models/dino_v3.py` `encoder_norm`: norm1 and norm2 of the 40 layers and
the final norm, [1374, 4096] bf16) as a share of its roofline. No
products, so the least time of each call is its bytes (x read and y written
once, weight and bias once: `portbench/counts/sam2l_dinov3_7b.norm_call`)
over the memory bandwidth; the measured time is the device time of K1's
kernels launched inside the call."""
from portbench.counts import sam2l_dinov3_7b as counts

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
KERNELS = ["ln_wide_kernel", "ln_slab_kernel"]


def _work(args, kwargs):
    x = args[1]                         # encoder_norm(norm, x)
    c = x.shape[-1]
    return counts.norm_call(x.numel() // c, c, x.element_size())


RANGES = counts.present({"pb.k.dinov3_norm": (
    "function", "no_time_to_train_tpu_torch.models.dino_v3",
    "encoder_norm")})
WORK = {"pb.k.dinov3_norm": _work}


def read(run):
    return run.roofline("pb.k.dinov3_norm", KERNELS)
