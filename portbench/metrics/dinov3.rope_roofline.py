"""DINOv3's RoPE (`models/dino_v3.py` `rope_patches`: the rotation of q's
or k's patch rows, eager elementwise kernels, 80 calls a request) as a
share of its roofline. No products, so the least time of each call is its
bytes (the patch rows read once and written once,
`portbench/counts/sam2l_dinov3_7b.rope_call`) over the memory bandwidth;
the measured time is the device time of every kernel launched inside the
call."""
from portbench.counts import sam2l_dinov3_7b as counts

LAYER = "semantic encoder"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]


def _work(args, kwargs):
    t, n_prefix = args[0], args[3]      # t [B, N, heads, D]
    b, n, heads, d = t.shape
    return counts.rope_call(b * (n - n_prefix), heads * d, t.element_size())


RANGES = counts.present({"pb.k.dinov3_rope": (
    "function", "no_time_to_train_tpu_torch.models.dino_v3", "rope_patches")})
WORK = {"pb.k.dinov3_rope": _work}


def read(run):
    return run.roofline("pb.k.dinov3_rope", None)
