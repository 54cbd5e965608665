"""Device activities (kernels, copies, memsets) launched inside the
program's `nttt.enqueue` spans (the body of `NoAMGMatcher.test_async`),
per request of the traced segment: an activity counts where the CUDA call
that launched it lies inside a span on the same thread."""
import bisect

LAYER = "matcher host path"
UNIT = "launches"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    if run.trace is None or not run.segment.finished:
        return None
    spans = {}
    for s, e, tid in run.trace.ranges.get("nttt.enqueue", ()):
        starts, ends = spans.setdefault(tid, ([], []))
        starts.append(s)
        ends.append(e)
    n = 0
    for _, _, _, ts, tid in run.trace.kernels:
        if ts is None or tid not in spans:
            continue
        starts, ends = spans[tid]
        i = bisect.bisect_right(starts, ts) - 1
        n += i >= 0 and ends[i] >= ts
    return n / run.segment.finished if n else None
