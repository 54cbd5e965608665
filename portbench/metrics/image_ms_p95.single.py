"""The 95th percentile of the request latencies of the measured window
(closed loop: `NoAMGMatcher.test` until `finalize_results` returns). On
seeded weights the tail is set by how many targets of the pool the
seed's weights make return 34-100 outputs, so it is kept here, without a
bound, and not as an end-to-end metric."""
import numpy as np

LAYER = "whole step"
UNIT = "ms"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    lat = run.record.latencies
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
