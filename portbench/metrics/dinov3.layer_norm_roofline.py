"""Kernel K1 (`ops/fused_ln.py` `layer_norm`, `csrc/layer_norm.cu`: the
wide-row kernel at C 4096) on DINOv3's 81 LayerNorms a request
(`models/dino_v3.py` `encoder_norm`: norm1 and norm2 of the 40 layers and
the final norm, [1374, 4096] bf16) as a share of its roofline. No
products, so the least time of each call is its bytes (x read and y written
once, weight and bias once); the calls are one request's, enumerated from
the configuration (`portbench/counts/sam2l_dinov3_7b.norm_calls`, each as
`norm_call` gives it), times the requests of the traced segment. The
measured time is the device time of K1's kernels (`ln_wide_kernel`,
`ln_slab_kernel`) inside the encoder's forward (`pb.dinov3`), which a CUDA
graph replayed inside it keeps. The wrapper on `encoder_norm` counts the
calls that eager code makes, for the run's notes only."""
from portbench.counts import sam2l_dinov3_7b as counts
from portbench.harness.tracing import template_args

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
K1 = ("ln_wide_kernel", "ln_slab_kernel")


def k1(name, grid):
    return template_args(name)[0].split("::")[-1] in K1


def _work(args, kwargs):
    x = args[1]                         # encoder_norm(norm, x)
    c = x.shape[-1]
    return counts.norm_call(x.numel() // c, c, x.element_size())


RANGES = {"pb.dinov3": ("module", "dino"),
          **counts.present({"pb.k.dinov3_norm": (
              "function", "no_time_to_train_tpu_torch.models.dino_v3",
              "encoder_norm")})}
WORK = {"pb.k.dinov3_norm": _work}


def read(run):
    return run.kernel_share("dinov3.layer_norm_roofline", ["pb.dinov3"], k1,
                            counts.norm_calls, seen="pb.k.dinov3_norm")
