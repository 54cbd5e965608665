"""Host time of the image's upload (`NoAMGMatcher._as_tensor` inside
`test_async`: 12.6 MB of float32, not pinned, copied to the card), per
request of the traced segment: the summed duration of the program's
`nttt.upload` spans (`utils/profiling.span`, profiler ranges on the clock of
the kernels) over the segment's requests. Taken under the profiler, so
longer than untraced; comparable between traced runs."""
LAYER = "matcher host path"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
SPAN = "nttt.upload"


def read(run):
    spans = run.trace.ranges.get(SPAN) if run.trace is not None else None
    if not spans or not run.segment.finished:
        return None
    return sum(e - s for s, e, _ in spans) * 1e-3 / run.segment.finished
