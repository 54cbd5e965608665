"""Parameter conversion, presets and the port's import boundary."""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest
import jax
import torch

from no_time_to_train_tpu.config import presets as jpresets
from no_time_to_train_tpu.models.dino import convert_hf_dinov2
from no_time_to_train_tpu.utils.torch_convert import convert_sam2
from no_time_to_train_tpu_torch.config import presets as tpresets
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.ops.attention import (
    check_attention_impl, set_attention_impl)
from no_time_to_train_tpu_torch.utils.convert import (
    dino_state_dict, sam2_state_dict)
from no_time_to_train_tpu_torch.utils.init import init_random_

CFG = jpresets.Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 2, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)
ENC = jpresets.EncoderConfig("tiny", 28, 14, 32, 2, 2, "local")


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_tree_equal(got, want):
    g, w = _flat(got), _flat(want)
    assert set(w) <= set(g), set(w) - set(g)
    for k in w:
        np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _port_sd(model):
    return {k: v.numpy() for k, v in model.state_dict().items()}


def _jax_sam2_params():
    """A port init, converted to the JAX tree by the JAX package's own
    converters (the direction real checkpoints take)."""
    tm = SAM2(CFG)
    init_random_(tm, torch.Generator().manual_seed(0))
    sd = _port_sd(tm)
    return convert_sam2(sd, CFG), sd


def test_sam2_round_trip_is_identity():
    params, sd = _jax_sam2_params()
    back = sam2_state_dict(params)
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    tm = SAM2(CFG)
    tm.load_state_dict({k: torch.as_tensor(v) for k, v in back.items()})
    _assert_tree_equal(convert_sam2(_port_sd(tm), CFG), params)
    for k in ("memory_encoder", "memory_attention", "maskmem_tpos_enc",
              "no_mem_embed", "no_mem_pos_enc", "no_obj_ptr", "obj_ptr_proj",
              "mask_downsample"):
        assert k in params, k


def test_dino_round_trip_is_identity():
    tm = DinoV2(ENC)
    init_random_(tm, torch.Generator().manual_seed(1))
    sd = _port_sd(tm)
    params = convert_hf_dinov2(sd, ENC)
    back = dino_state_dict(params, ENC)
    assert set(back) == set(sd)
    for k in sd:
        if k != "embeddings.mask_token":          # not in the JAX tree
            np.testing.assert_array_equal(back[k], sd[k], err_msg=k)
    _assert_tree_equal(convert_hf_dinov2(back, ENC), params)


def test_presets_equal_the_jax_package():
    for name, cfg in tpresets.SAM2_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jpresets.SAM2_PRESETS[name]), name
    for name, cfg in tpresets.ENCODER_PRESETS.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(
            jpresets.ENCODER_PRESETS[name]), name


def test_attention_impl_pallas_refused_on_cuda_only():
    """Kept under its old name: "pallas" is now accepted whatever the
    device (the check no longer takes one), bad names are refused, and
    `set_attention_impl` reaches every attention module of a model and
    nothing outside it."""
    for impl in ("pallas", "xla"):
        check_attention_impl(impl)
    for bad in ("flash", "PALLAS", None):
        with pytest.raises(ValueError):
            check_attention_impl(bad)
    a, b = SAM2(CFG), DinoV2(ENC)
    set_attention_impl(a, "xla")
    attn = [m for m in a.modules() if hasattr(m, "attention_impl")]
    # one per Hiera block, two (self, memory cross) per memory-attention layer
    assert len(attn) == sum(CFG.stages) + 2 * CFG.mem_attn_layers
    assert all(m.attention_impl == "xla" for m in attn)
    assert all(m.attention_impl == "pallas" for m in b.modules()
               if hasattr(m, "attention_impl"))
    with pytest.raises(ValueError):
        set_attention_impl(b, "flash")


_IMPORT_ALL = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "yaml", "PIL"):
    sys.modules[name] = None          # any import of them now fails
import no_time_to_train_tpu_torch as pkg
mods = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
leaked = [m for m in sys.modules if m.split(".")[0] == "no_time_to_train_tpu"]
assert not leaked, leaked
print(len(mods))
"""


def test_port_imports_without_jax_flax_yaml():
    """Nor PIL: the machine with the card has none."""
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
