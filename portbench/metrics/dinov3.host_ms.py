"""Host time of the semantic encoder (`NoAMGMatcher._target_features`: the
bicubic resize to 592^2, the normalisation and DINOv3 ViT-7B/16, launched
eagerly), per request of the traced segment: the summed duration of the
program's `nttt.dino` spans (`utils/profiling.span`, profiler ranges on the
clock of the kernels) over the segment's requests. Taken under the profiler,
so longer than untraced; comparable between traced runs."""
LAYER = "semantic encoder"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
SPAN = "nttt.dino"


def read(run):
    spans = run.trace.ranges.get(SPAN) if run.trace is not None else None
    if not spans or not run.segment.finished:
        return None
    return sum(e - s for s, e, _ in spans) * 1e-3 / run.segment.finished
