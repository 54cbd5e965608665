"""Device time of the image encoder (`models/sam2/hiera.py`, `neck.py`:
Hiera + FPN at 1024^2) per request of the traced segment: the kernels
launched inside `sam2.image_encoder`'s forward."""
LAYER = "image encoder"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
RANGES = {"pb.hiera": ("module", "sam2.image_encoder")}


def read(run):
    return run.range_ms("pb.hiera")
