"""Device time of the matching tail (`NoAMGMatcher._match`: scoring, NMS,
IoS decay and top-K) per request of the traced segment: the kernels,
copies and memsets launched inside the program's `nttt.match` spans."""
LAYER = "matching tail"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    return run.range_ms("nttt.match")
