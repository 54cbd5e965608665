"""The host's launch speed as the run's process sees it, outside the
program: us per launch of 2000 one-element additions on the card until
the last returns, the least of 5 tries, the mean of the readings just
before and just after the measured window. The closed loop is host-bound
(the card idles most of a request), so `image_ms_p50` moves with this
from process to process; read it beside the p50 to tell a change in the
program from a slower host."""
LAYER = "host"
UNIT = "us"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    return sum(b for _, b in run.probes) / len(run.probes)
