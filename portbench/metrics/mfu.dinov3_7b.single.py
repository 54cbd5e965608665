"""The whole test step's share of the card's bf16 peak on Hiera-L + DINOv3
ViT-7B/16: the model's operations per image
(`portbench/counts/sam2l_dinov3_7b.py`, about 24.95 TFLOP) x the images
finished in the measured window / the window's seconds / the peak."""
LAYER = "whole step"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]


def read(run):
    return run.mfu()
