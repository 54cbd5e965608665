"""Checkpoint IO (port of `no_time_to_train_tpu/utils/checkpoint.py`).

Three checkpoint kinds, mirroring the reference (SURVEY §5):
  1. SAM2 weights: torch `.pt` with `["model"]` state dict
     (sam2/build_sam.py:119-129). The port's modules use the reference's
     names, so the state dict loads as it is, with `strict=True`.
  2. Encoder (DINOv2 / DINOv3) weights: a local HF model directory, read
     from `*.safetensors` by the reader below or from `*.bin` by
     `torch.load`. A hub name is refused: the port has no `transformers` and
     no network.
  3. Memory bank: the phase checkpoints written after fill / postprocess, as
     Lightning-compatible torch checkpoints (state-dict keys
     `seg_model.memory_bank[_neg].<field>`, interoperable with the
     reference's --ckpt_path flow, sam2matcher_pl.py:140-142, and with the
     JAX package's files both ways).
"""
import json
import os
import struct
from dataclasses import replace

import numpy as np
import torch

__all__ = ["BANK_FIELDS", "load_sam2_torch_checkpoint", "load_dino_checkpoint",
           "read_safetensors", "save_memory_bank", "load_memory_bank"]

BANK_FIELDS = ["fill_counts", "feats", "masks", "feats_avg", "feats_ins_avg",
               "feats_covariances", "feats_centers", "ins_sim_avg", "pca_mean",
               "pca_components", "postprocessed"]

_SAFETENSORS_DTYPES = {"F64": "<f8", "F32": "<f4", "F16": "<f2", "I64": "<i8",
                       "I32": "<i4", "I16": "<i2", "I8": "i1", "U8": "u1",
                       "BOOL": "?"}


def load_sam2_torch_checkpoint(path):
    """Reference .pt checkpoint -> its reference-named state dict (torch
    tensors), which `NoAMGMatcher(sam2_state_dict=...)` loads with
    strict=True."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd["model"] if "model" in sd else sd


def read_safetensors(path):
    """A `.safetensors` file -> {name: numpy array}: an 8-byte little-endian
    header length, a JSON header of dtype / shape / byte offsets, then the
    raw little-endian tensors (memory-mapped)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    data = np.memmap(path, dtype=np.uint8, mode="r", offset=8 + n)
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        start, end = info["data_offsets"]
        raw = data[start:end]
        if info["dtype"] == "BF16":
            arr = (raw.view("<u2").astype(np.uint32) << 16).view(np.float32)
        elif info["dtype"] in _SAFETENSORS_DTYPES:
            arr = raw.view(_SAFETENSORS_DTYPES[info["dtype"]])
        else:
            raise ValueError(f"{path}: tensor {name} has dtype "
                             f"{info['dtype']}, which this reader does not "
                             f"know")
        out[name] = arr.reshape(info["shape"])
    return out


def load_dino_checkpoint(path):
    """Local HF model directory -> its state dict as float32 numpy arrays
    (HF Dinov2Model / DINOv3ViTModel names, which the port's encoders
    use)."""
    if not os.path.isdir(str(path)):
        raise FileNotFoundError(
            f"encoder checkpoint {path!r} is not a local directory; the port "
            f"reads local HF snapshots only (no transformers, no hub download)")
    files = sorted(f for f in os.listdir(path) if f.endswith(".safetensors"))
    sd = {}
    if files:
        for f in files:
            sd.update({k: np.asarray(v, np.float32) for k, v in
                       read_safetensors(os.path.join(path, f)).items()})
        return sd
    bins = sorted(f for f in os.listdir(path) if f.endswith(".bin"))
    if not bins:
        raise FileNotFoundError(f"{path}: no *.safetensors or *.bin file")
    for b in bins:
        part = torch.load(os.path.join(path, b), map_location="cpu",
                          weights_only=True)
        sd.update({k: v.float().numpy() for k, v in part.items()})
    return sd


def save_memory_bank(path, bank, bank_neg=None):
    state = {}
    for prefix, b in (("seg_model.memory_bank", bank),
                      ("seg_model.memory_bank_neg", bank_neg)):
        if b is None:
            continue
        for f in BANK_FIELDS:
            v = getattr(b, f)
            state[f"{prefix}.{f}"] = (v.detach().cpu().clone()
                                      if torch.is_tensor(v)
                                      else torch.tensor(bool(v)))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({"state_dict": state}, path)


def load_memory_bank(path, bank, bank_neg=None):
    """Restore banks from a phase checkpoint (the port's, the JAX
    package's torch-format one, or the reference's Lightning .ckpt) onto
    the devices and dtypes of `bank` / `bank_neg`."""
    # a Lightning .ckpt also pickles its hyper-parameters
    state = torch.load(path, map_location="cpu",
                       weights_only=False)["state_dict"]

    def restore(b, prefix):
        reps = {}
        for f in BANK_FIELDS:
            key = f"{prefix}.{f}"
            if key not in state:
                continue
            val = state[key]
            if f == "postprocessed":
                reps[f] = bool(val.reshape(-1)[0])
                continue
            cur = getattr(b, f)
            if tuple(val.shape) != tuple(cur.shape):
                raise ValueError(f"{path}: {key} has shape "
                                 f"{tuple(val.shape)}, the bank "
                                 f"{tuple(cur.shape)}")
            reps[f] = val.to(dtype=cur.dtype, device=cur.device)
        return replace(b, **reps)

    bank = restore(bank, "seg_model.memory_bank")
    if bank_neg is not None:
        bank_neg = restore(bank_neg, "seg_model.memory_bank_neg")
    return bank, bank_neg
