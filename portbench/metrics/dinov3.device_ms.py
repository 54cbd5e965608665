"""Device time of the semantic encoder (`models/dino_v3.py`, DINOv3
ViT-7B/16 on the 592^2 target, eager: no CUDA graph) per request of the
traced segment: the kernels launched inside the matcher's `dino` forward."""
LAYER = "semantic encoder"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
RANGES = {"pb.dinov3": ("module", "dino")}


def read(run):
    return run.range_ms("pb.dinov3")
