"""Share of the traced segment in which no kernel, copy or memset ran on
the device, on Hiera-L + DINOv3 ViT-7B/16: 100 x (1 - busy / window), busy
the union of device activity in the window from the first traced request's
start to the last one's end."""
LAYER = "device"
UNIT = "%"
MOVES = "image_ms_p50"
WORKLOADS = ["sam2l_dinov3_7b.single"]


def read(run):
    return run.idle_pct()
