"""The whole test step's share of the card's bf16 peak: the model's
operations per image (`portbench/counts/<config>.py`) x the images
finished in the measured window / the window's seconds / the peak."""
LAYER = "whole step"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov2l.single", "sam2s_dinov2l.single"]


def read(run):
    return run.mfu()
