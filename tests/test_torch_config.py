"""The port's YAML reader (`config/yaml_lite.py`) against PyYAML, its hydra
topology parser against the JAX package's, and the matcher built from a
topology YAML (ROADMAP C.9)."""
import dataclasses
import glob
import os

import pytest
import torch
import yaml

from no_time_to_train_tpu.config import hydra_yaml as j_hydra
from no_time_to_train_tpu_torch.config import hydra_yaml as t_hydra
from no_time_to_train_tpu_torch.config import presets as t_presets
from no_time_to_train_tpu_torch.config import yaml_lite
from no_time_to_train_tpu_torch.models.matching.pipeline import (
    MatchingConfig, NoAMGMatcher)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml"))
                 + glob.glob(os.path.join(ROOT, "pl_configs", "*.yaml")))

# the user topology of tests/test_hydra_yaml.py::test_custom_variant_builds
CUSTOM_TOPOLOGY = {"model": {
    "_target_": "sam2.modeling.sam2_base.SAM2Base",
    "image_encoder": {
        "_target_": "sam2.modeling.backbones.image_encoder.ImageEncoder",
        "scalp": 1,
        "trunk": {
            "_target_": "sam2.modeling.backbones.hieradet.Hiera",
            "embed_dim": 64, "num_heads": 2, "stages": [1, 2, 4, 2],
            "global_att_blocks": [3, 5, 7],
            "window_pos_embed_bkg_spatial_size": [7, 7],
            "window_spec": [4, 2, 8, 4]},
        "neck": {
            "_target_": "sam2.modeling.backbones.image_encoder.FpnNeck",
            "position_encoding": {"num_pos_feats": 256},
            "d_model": 256,
            "backbone_channel_list": [512, 256, 128, 64],
            "fpn_top_down_levels": [2, 3],
            "fpn_interp_model": "nearest"}},
    "memory_attention": {
        "num_layers": 2,
        "layer": {"dim_feedforward": 1024,
                  "self_attention": {"feat_sizes": [16, 16]},
                  "cross_attention": {"kv_in_dim": 32}}},
    "memory_encoder": {"out_dim": 32},
    "num_maskmem": 5, "image_size": 512,
    "use_high_res_features_in_sam": True,
    "compile_image_encoder": False,
}}

# a Hiera small enough to build on the CPU in a test
TINY_TOPOLOGY = {"model": {
    "_target_": "sam2.modeling.sam2_base.SAM2Base",
    "image_encoder": {
        "scalp": 1,
        "trunk": {"embed_dim": 32, "num_heads": 1, "stages": [1, 1, 1, 1],
                  "global_att_blocks": [2],
                  "window_pos_embed_bkg_spatial_size": [2, 2],
                  "window_spec": [4, 2, 4, 2]},
        "neck": {"d_model": 256, "backbone_channel_list": [256, 128, 64, 32],
                 "fpn_top_down_levels": [2, 3],
                 "fpn_interp_model": "nearest"}},
    "memory_attention": {"num_layers": 1,
                         "layer": {"dim_feedforward": 64}},
    "image_size": 128,
}}
TINY_FIELDS = dict(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128,
    mem_attn_layers=1, mem_attn_dim_feedforward=64)


@pytest.mark.parametrize("path", CONFIGS,
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_yaml_lite_reads_every_config_as_pyyaml(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    assert yaml_lite.load_file(path) == want


@pytest.mark.parametrize("tree", [
    CUSTOM_TOPOLOGY, TINY_TOPOLOGY,
    {"a": [1, -2, 0.5, 1e-5, "0017", "yes", "", None, True],
     "b": {"c": [[1, 2], ["x y", "z: w"]], "d": {}, "e": []},
     "f": "#not a comment", "g": "it's", "h": 12345678901234}],
    ids=["custom", "tiny", "scalars"])
def test_yaml_lite_reads_dumped_trees_as_pyyaml(tree):
    """Block style, as `yaml.safe_dump` writes by default."""
    text = yaml.safe_dump(tree)
    assert yaml_lite.safe_load(text) == yaml.safe_load(text)


def test_yaml_lite_resolves_scalars_as_pyyaml():
    text = "\n".join([
        "a: 1e-5", "b: 1.5e+3", "c: 0x1F", "d: 017", "e: +.inf", "f: .NaN",
        "g: on", "h: Off", "i: ~", "j: ''", "k: \"t\\tx\\u00e9\"",
        "l: [a, 'b, c', [1, 2.5]]  # comment", "m: -0", "n: 1_000",
        "o: 0b101", "p: null", "q: 'don''t'", "r: v # x", "s: .5",
        "---not: a marker"])
    got, want = yaml_lite.safe_load(text), yaml.safe_load(text)
    assert got.keys() == want.keys()
    for k in want:
        if k == "f":
            assert got[k] != got[k] and want[k] != want[k]     # nan
        else:
            assert got[k] == want[k] and type(got[k]) is type(want[k]), k


@pytest.mark.parametrize("text", [
    "a: &x 1\nb: *x\n",                      # anchor and alias
    "a: [1, 2]\nb: *x\n",                    # alias
    "a: 1\n---\nb: 2\n",                     # several documents
    "---\na: 1\n...\n---\nb: 2\n",
    "a: !!str 1\n",                          # tag
    "a: |\n  text\n",                        # block scalars
    "a: >\n  text\n",
    "a: {b: 1}\n",                           # flow map with entries
    "a: b: c\n",
    "a:\n  plain scalar\n  over two lines\n",
])
def test_yaml_lite_refuses_what_it_does_not_read(text):
    with pytest.raises(yaml_lite.YamlError):
        yaml_lite.safe_load(text)


def _write(tmp_path, tree, name="topology.yaml"):
    path = tmp_path / name
    path.write_text(yaml.safe_dump(tree))
    return str(path)


@pytest.mark.parametrize("tree", [CUSTOM_TOPOLOGY, TINY_TOPOLOGY],
                         ids=["custom", "tiny"])
def test_load_sam2_yaml_matches_jax(tmp_path, tree):
    path = _write(tmp_path, tree)
    got = dataclasses.asdict(t_hydra.load_sam2_yaml(path))
    want = dataclasses.asdict(j_hydra.load_sam2_yaml(path))
    assert got == want


def test_resolve_sam2_cfg_and_key_checks_match_jax(tmp_path):
    for name in t_presets.SAM2_PRESETS:
        assert t_hydra.resolve_sam2_cfg(f"/elsewhere/{name}") \
            == t_presets.SAM2_PRESETS[name]
    with pytest.raises(KeyError):
        t_hydra.resolve_sam2_cfg("no_such_topology.yaml")
    for bad in ({"model": {"not_a_sam2_flag": 1}},
                {"model": {"image_encoder": {"trunk": {"mystery_dim": 7}}}}):
        path = _write(tmp_path, bad, "bad.yaml")
        with pytest.raises(ValueError) as t_err:
            t_hydra.load_sam2_yaml(path)
        with pytest.raises(ValueError) as j_err:
            j_hydra.load_sam2_yaml(path)
        assert str(t_err.value) == str(j_err.value)


def test_matcher_builds_a_topology_yaml_as_its_config(tmp_path):
    """C.9: `NoAMGMatcher` takes a topology YAML path where a preset name
    goes, and builds the model the equal `Sam2Config` builds."""
    path = _write(tmp_path, TINY_TOPOLOGY)
    enc = t_presets.EncoderConfig("tiny", 28, 14, 32, 1, 2, "local")
    cfg = t_presets.Sam2Config(**TINY_FIELDS)
    from_yaml = NoAMGMatcher(path, enc, MatchingConfig(), n_classes=2,
                             memory_length=2, seed=3, device="cpu")
    from_cfg = NoAMGMatcher(cfg, enc, MatchingConfig(), n_classes=2,
                            memory_length=2, seed=3, device="cpu")
    assert from_yaml.sam2_cfg == cfg
    got, want = from_yaml.sam2.state_dict(), from_cfg.sam2.state_dict()
    assert list(got) == list(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
