"""Operation counts of the `sam2l_dinov2l` configuration: the test step's
formulas of `portbench/counts/common.py` on this configuration's shapes
(`portbench/configs/sam2l_dinov2l.json`)."""
from portbench.counts import common


def image_flops(config):
    """Operations of one test image."""
    return common.image_flops(config)
