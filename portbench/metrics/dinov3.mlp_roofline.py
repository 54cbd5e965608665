"""DINOv3's MLP (`models/dino_v3.py` `mlp_block`: the SwiGLU
down(silu(gate x) * up x) of width 8192 on the 1374 tokens, cuBLAS products
and eager elementwise kernels) as a share of its roofline. The least time of
each call is the larger of its operations (6 n D H) over the card's bf16
peak and its bytes (weights, biases, input and output once) over the memory
bandwidth, from the call's operands (`portbench/counts/sam2l_dinov3_7b.
mlp_call`); the measured time is the device time of every kernel launched
inside the call."""
from portbench.counts import sam2l_dinov3_7b as counts

LAYER = "semantic encoder"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]


def _work(args, kwargs):
    mlp, x = args[0], args[1]           # the _MLP, x [B, N, D]
    d = x.shape[-1]
    return counts.mlp_call(x.numel() // d, d, mlp.hidden, mlp.gated,
                           x.element_size())


RANGES = counts.present({"pb.k.dinov3_mlp": (
    "function", "no_time_to_train_tpu_torch.models.dino_v3", "mlp_block")})
WORK = {"pb.k.dinov3_mlp": _work}


def read(run):
    return run.roofline("pb.k.dinov3_mlp", None)
