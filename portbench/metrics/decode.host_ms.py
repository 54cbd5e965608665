"""Host time of the grid decode (every chunk of
`NoAMGMatcher._decode_grid_batch`'s loop, 4 of 256 prompts a request), per
request of the traced segment: the summed duration of the program's
`nttt.decode` spans (`utils/profiling.span`, profiler ranges on the clock of
the kernels) over the segment's requests. Taken under the profiler, so
longer than untraced; comparable between traced runs."""
LAYER = "grid decode"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]
SPAN = "nttt.decode"


def read(run):
    spans = run.trace.ranges.get(SPAN) if run.trace is not None else None
    if not spans or not run.segment.finished:
        return None
    return sum(e - s for s, e, _ in spans) * 1e-3 / run.segment.finished
