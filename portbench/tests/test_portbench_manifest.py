"""BENCHMARK.json against the form its readers expect, and against the files it
names: every name and unit in the allowed characters, each metric's reader
file agreeing with its manifest entry, each configuration file with its
source and cuts, and the check's time budget."""
import json
import os
import re

import pytest

from portbench.harness.cells import Cell, load_module

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert all(PATH.match(p) and not p.startswith("/") and ".." not in p
               for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= manifest["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units(manifest, section):
    entries = manifest[section]
    names = [e["name"] for e in entries]
    assert len(names) == len(set(names))
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and section != "end_to_end" and section != "per_layer":
                assert _line(e[key]), (e["name"], key)
        if section == "configs":
            assert set(e) == {"name", "source", "file", "reduced", "why"}
            assert len(e["reduced"]) <= 16
            assert all(NAME.match(k) for k in e["reduced"])
            assert e["file"].startswith("portbench/")
        if section == "workloads":
            assert set(e) == {"name", "config", "traffic", "chips", "why"}
            assert e["chips"] in (1, 4)
            assert NAME.match(e["config"]) and NAME.match(e["traffic"])
        if section == "end_to_end":
            assert set(e) - {"workloads"} == {"name", "unit", "better",
                                              "bound", "source"}
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25
        if section == "per_layer":
            assert set(e) - {"workloads"} == {"name", "unit", "better",
                                              "source", "layer", "moves"}
            assert e["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert _line(e["layer"])


def test_every_cell_reports_enough(manifest):
    names = {e["name"] for e in manifest["end_to_end"]}
    assert "setup_s" in names
    for w in manifest["workloads"]:
        e2e = [m for m in manifest["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
        pl = [m for m in manifest["per_layer"]
              if w["name"] in m.get("workloads", [w["name"]])]
        assert any(m["name"] == "setup_s" for m in e2e)
        assert len(e2e) >= 2 and pl, w["name"]
        for m in pl:
            assert m["moves"] in {x["name"] for x in e2e}, (w["name"], m)
    for cfg in manifest["configs"]:
        assert any(w["config"] == cfg["name"] for w in manifest["workloads"])
    assert sum(w["chips"] == 4 for w in manifest["workloads"]) <= max(
        1, len(manifest["workloads"]) // 4)


def test_check_fits_the_budget(manifest):
    """2 + 14 runs a cell at run_seconds + 60 s, 2 x 90 s a cell to
    compile, 1200 s spare: within 43200 s with the full 24 cells."""
    cells = 24
    total = (2 + 14 * cells) * (manifest["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200


def test_metric_files_agree(manifest):
    for m in manifest["per_layer"]:
        path = os.path.join(ROOT, "portbench", "metrics", m["name"] + ".py")
        mod = load_module(path, "m_" + m["name"].replace(".", "_"))
        assert mod.LAYER == m["layer"]
        assert mod.UNIT == m["unit"]
        assert mod.MOVES == m["moves"]
        assert mod.WORKLOADS == m["workloads"]
        assert callable(mod.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher"


def encoder_agrees(cfg):
    """The configuration's `topology.dino` against the preset it names
    (with its overrides) and against the encoder module that the program's
    matcher builds for it on the meta device: the shapes, the family and,
    for DINOv3, the registers, the MLP's width and whether it is gated."""
    from portbench.harness.program import _spec, program_configs
    _, enc = program_configs(cfg)
    dino = cfg["topology"]["dino"]
    assert (enc.img_size, enc.patch_size, enc.feat_dim, enc.depth,
            enc.num_heads) == (dino["img_size"], dino["patch_size"],
                               dino["dim"], dino["depth"], dino["heads"])
    family = dino.get("family", "dinov2")
    assert enc.family == family, (enc.family, family)
    leaves = {n: s for n, s, _ in _spec(cfg)[1]}
    if family == "dinov3":
        assert enc.num_register_tokens == dino["registers"]
        assert leaves["embeddings.register_tokens"][1] == dino["registers"]
        assert leaves["layer.0.mlp.up_proj.weight"][0] == dino["mlp_hidden"]
        assert ("layer.0.mlp.gate_proj.weight" in leaves) == dino["gated"]
        assert dino["act"] in ("gelu", "silu")
    else:
        assert leaves["encoder.layer.0.mlp.fc1.weight"][0] == \
            dino["mlp_ratio"] * dino["dim"]


def test_config_files_agree(manifest):
    from no_time_to_train_tpu_torch.config.presets import SAM2_PRESETS
    for entry in manifest["configs"]:
        with open(os.path.join(ROOT, entry["file"])) as f:
            cfg = json.load(f)
        assert cfg["name"] == entry["name"]
        assert cfg["source"] == entry["source"]
        assert cfg["reduced"] == entry["reduced"]
        assert all(k in cfg for k in cfg["reduced"])
        # the program's presets are the configuration's topology
        hiera = cfg["topology"]["hiera"]
        sam2 = SAM2_PRESETS[cfg["program"]["sam2_cfg"]]
        for key in ("embed_dim", "num_heads", "stages", "global_att_blocks",
                    "window_spec", "window_pos_embed_bkg_spatial_size",
                    "backbone_channel_list", "d_model",
                    "fpn_top_down_levels", "scalp", "image_size"):
            got = getattr(sam2, key)
            assert list(got) == hiera[key] if isinstance(got, tuple) \
                else got == hiera[key], key
        encoder_agrees(cfg)
        assert not cfg["program"].get("sam2_overrides")
        assert not cfg["program"].get("encoder_overrides")


def _dinov3_file(preset, block, kind=None):
    from conftest import tiny_dinov3_config
    if kind:
        return tiny_dinov3_config(kind)
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sam2l_dinov2l.json")) as f:
        cfg = json.load(f)
    cfg["program"]["encoder_cfg"] = preset
    cfg["topology"]["dino"] = block
    return cfg


def _published(preset):
    from conftest import dinov3_block
    return {"dinov3_large": dinov3_block(1024, 24, 16, 4096, False),
            "dinov3_huge": dinov3_block(1280, 32, 20, 5120, True,
                                        "silu")}[preset]


@pytest.mark.parametrize("preset,kind", [
    ("dinov3_large", None), ("dinov3_huge", None), (None, "plain"),
    (None, "gated")])
def test_dinov3_topology_agrees(preset, kind):
    encoder_agrees(_dinov3_file(preset, preset and _published(preset),
                                kind))


@pytest.mark.parametrize("key,value", [
    ("gated", True), ("mlp_hidden", 8192), ("registers", 0),
    ("family", None), ("dim", 4096)])
def test_misstated_dinov3_topology_fails(key, value):
    """A file whose DINOv3 block misstates the preset it names fails on
    the CPU."""
    block = dict(_published("dinov3_large"))
    if value is None:
        del block[key]
    else:
        block[key] = value
    with pytest.raises(AssertionError):
        encoder_agrees(_dinov3_file("dinov3_large", block))


def test_cells_resolve(manifest):
    for w in manifest["workloads"]:
        cell = Cell(w["name"])
        assert cell.traffic["loop"] == "closed"
        assert set(cell.readers) == {m["name"] for m in cell.per_layer}
        assert cell.counts.image_flops(cell.config) > 0
        limits = json.load(open(os.path.join(
            ROOT, "portbench", "limits", w["config"] + ".json")))["limits"]
        from portbench.harness.check import NUMBERS
        assert set(limits) == set(NUMBERS)
