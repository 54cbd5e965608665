"""Device activities (kernels, copies, memsets) launched inside the
matcher's `dino` forward (DINOv3 ViT-7B/16, eager), per request of the
traced segment: an activity counts where the CUDA call that launched it
lies inside the range on the same thread, as `enqueue.launches` counts
them inside `nttt.enqueue`."""
import bisect

LAYER = "semantic encoder"
UNIT = "launches"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]
RANGES = {"pb.dinov3": ("module", "dino")}


def read(run):
    if run.trace is None or not run.segment.finished:
        return None
    spans = {}
    for s, e, tid in run.trace.ranges.get("pb.dinov3", ()):
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
