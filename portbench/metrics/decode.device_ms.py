"""Device time of the grid decode (`models/sam2/prompt_encoder.py`,
`mask_decoder.py`, `transformer.py`: 4 chunks of 256 point prompts) per
request of the traced segment: the kernels launched inside
`sam2.forward_sam_heads_best`."""
LAYER = "grid decode"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
RANGES = {"pb.decode": ("method", "sam2.forward_sam_heads_best")}


def read(run):
    return run.range_ms("pb.decode")
