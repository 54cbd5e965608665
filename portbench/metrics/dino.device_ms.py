"""Device time of the semantic encoder (`models/dino.py`, DINOv2 on the
518^2 target) per request of the traced segment: the kernels launched
inside the matcher's `dino` forward."""
LAYER = "semantic encoder"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
RANGES = {"pb.dino": ("module", "dino")}


def read(run):
    return run.range_ms("pb.dino")
