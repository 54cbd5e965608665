"""Kernel K4 (`ops/upscale_product.py` `fused_post_t1`,
`csrc/upscale_product.cu`): the decoder's upscaling and hypernetwork
product, as a share of its roofline. The least time of each call is the
larger of its operations over the card's bf16 peak and its bytes (inputs
once, output once); the calls are one request's, enumerated from the
configuration (`portbench/counts/common.upscale_calls`: a call a chunk of
the grid's prompts, each as `common.upscale_call` gives it), times the
requests of the traced segment. The measured time is the device time of
`post_t1_mma_kernel<false>` (the kernel of `fused_post_t1`; `<true>` is
`fused_post_t1_from_t1`'s) inside the grid decode
(`sam2.forward_sam_heads_best`, `pb.decode`), which a CUDA graph replayed
inside it keeps. The wrapper on the Python function counts the calls that
eager code makes, for the run's notes only."""
from portbench.counts import common
from portbench.harness.tracing import template_args

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def k4(name, grid):
    base, args = template_args(name)
    return base.split("::")[-1] == "post_t1_mma_kernel" and args == ("false",)


def _work(args, kwargs):
    src = args[0]                      # [prompts, hw, C]
    return common.upscale_call(src.shape[0], src.shape[1], src.shape[2],
                               src.element_size())


RANGES = {"pb.decode": ("method", "sam2.forward_sam_heads_best"),
          "pb.k.fused_post_t1": (
              "function",
              "no_time_to_train_tpu_torch.models.sam2.mask_decoder",
              "fused_post_t1")}
WORK = {"pb.k.fused_post_t1": _work}


def read(run):
    return run.kernel_share("fused_post_t1_roofline", ["pb.decode"], k4,
                            common.upscale_calls, seen="pb.k.fused_post_t1")
