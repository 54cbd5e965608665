"""Host time of `NoAMGMatcher.test_async` until it returns with the
image's work queued, mean per request of the measured window (closed
loop: `test` calls it, then waits in `fetch_test`)."""
LAYER = "matcher host path"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    return run.span_ms("enqueue")
