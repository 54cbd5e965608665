"""Kernel 10 (`ops/flash_attention.py` `flash_sdpa_window_qkv`,
`csrc/window_attn.cu` on the tiles of `csrc/attn_mma.cuh`): Hiera's
windowed attention on a packed qkv, as a share of its roofline. The least
time of each call is the larger of its operations (both products over the
windows' real head width) over the card's bf16 peak and its bytes (qkv
read once, output written once) over the memory bandwidth, from the call's
operand shapes (`portbench/counts/common.window_call`); the measured time
is the device time of the attention kernels launched inside the call."""
from portbench.counts import common

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
KERNELS = ["attn_mma::attn_kernel", "attn_mma::attn_wg_kernel",
           "attn_mma::merge_kernel"]


def _work(args, kwargs):
    qkv, win = args[0], args[2]        # qkv [1, tokens, 3 C], window tokens
    return common.window_call(qkv.shape[1], qkv.shape[2] // 3, win,
                              qkv.element_size())


RANGES = {"pb.k.flash_sdpa_window_qkv": (
    "function", "no_time_to_train_tpu_torch.ops.attention",
    "flash_sdpa_window_qkv")}
WORK = {"pb.k.flash_sdpa_window_qkv": _work}


def read(run):
    return run.roofline("pb.k.flash_sdpa_window_qkv", KERNELS)
