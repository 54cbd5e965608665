"""What the port's front ends (`scripts/`, `examples/`) share: the device
they run on, the compute dtype on it, and a SAM2 from a reference
checkpoint or from a seed."""
import os

import torch

from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.ops.attention import set_attention_impl
from no_time_to_train_tpu_torch.utils.checkpoint import (
    load_sam2_torch_checkpoint)
from no_time_to_train_tpu_torch.utils.init import init_random_

__all__ = ["entry_device", "compute_dtype", "build_sam2"]


def entry_device(name):
    """`--device` of a front end as a torch device. `cuda` (the default of
    every entry) raises where there is no CUDA device: nothing falls back
    to the CPU unless asked for with `--device cpu`."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this entry runs on the GPU; pass "
                           "--device cpu to run it on the CPU")
    return dev


def compute_dtype(device):
    """bf16 on a GPU, float32 elsewhere (the JAX package computes in bf16 on
    its accelerator, the TPU, and in float32 on the CPU)."""
    return torch.bfloat16 if torch.device(device).type == "cuda" \
        else torch.float32


def build_sam2(cfg, ckpt=None, *, device, dtype, seed=0):
    """SAM2 of topology `cfg` on `device` in `dtype` under
    attention_impl="pallas": the reference checkpoint `ckpt` where the file
    exists, else weights drawn from `seed` (`utils/init.init_random_`, on a
    generator of `device`)."""
    device = torch.device(device)
    with torch.device("meta"):
        model = SAM2(cfg)
    model = model.to_empty(device=device)
    if ckpt and os.path.exists(ckpt):
        model.load_state_dict(load_sam2_torch_checkpoint(ckpt), strict=True)
    else:
        init_random_(model, torch.Generator(device).manual_seed(seed))
    model = model.to(dtype).eval().requires_grad_(False)
    return set_attention_impl(model, "pallas")
