"""Kernel 10 (`ops/flash_attention.py` `flash_sdpa_window_qkv`,
`csrc/window_attn.cu` on the tiles of `csrc/attn_mma.cuh`): Hiera's
windowed attention on a packed qkv, as a share of its roofline. The least
time of each call is the larger of its operations (both products over the
windows' real head width) over the card's bf16 peak and its bytes (qkv
read once, output written once); the calls are one request's, enumerated
from the configuration (`portbench/counts/common.window_calls`: the
windowed blocks that the program's gate sends to the kernel, each as
`common.window_call` gives it), times the requests of the traced segment.
The measured time is the device time of kernel 10's launches, by name and
grid (`portbench/harness/kernels.window_qkv`), inside the image encoder's
forward (`pb.hiera`), which a CUDA graph replayed inside it keeps. The
wrapper on the Python function counts the calls that eager code makes, for
the run's notes only."""
from portbench.counts import common
from portbench.harness import kernels

LAYER = "kernels"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def _work(args, kwargs):
    qkv, win = args[0], args[2]        # qkv [1, tokens, 3 C], window tokens
    return common.window_call(qkv.shape[1], qkv.shape[2] // 3, win,
                              qkv.element_size())


RANGES = {"pb.hiera": ("module", "sam2.image_encoder"),
          "pb.k.flash_sdpa_window_qkv": (
              "function", "no_time_to_train_tpu_torch.ops.attention",
              "flash_sdpa_window_qkv")}
WORK = {"pb.k.flash_sdpa_window_qkv": _work}


def read(run):
    return run.kernel_share("flash_sdpa_window_qkv_roofline", ["pb.hiera"],
                            kernels.window_qkv, common.window_calls,
                            seen="pb.k.flash_sdpa_window_qkv")
