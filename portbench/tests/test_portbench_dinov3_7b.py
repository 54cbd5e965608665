"""The `sam2l_dinov3_7b` configuration on the CPU: its operation count
against torch's FLOP counter over the plain reference on the meta device,
each roofline's work function at the 7B's shapes against values worked by
hand, its file against the module the program builds for it, and its
readers on a program or a trace without what they read."""
import json
import os
import types
from types import SimpleNamespace

import pytest
import torch

from portbench.counts import common
from portbench.counts import sam2l_dinov3_7b as counts
from portbench.harness.cells import Cell, load_module
from portbench.reference import models
from test_portbench_counts import _meta_sd, _meta_weights
from test_portbench_manifest import encoder_agrees

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CELL = "sam2l_dinov3_7b.single"
READERS = ["dinov3.device_ms", "dinov3.host_ms", "dinov3.launches",
           "dinov3.mlp_roofline", "dinov3.rope_roofline",
           "dinov3.flash_sdpa_bnhd_roofline", "dinov3.layer_norm_roofline",
           "mfu.dinov3_7b.single", "device.idle.dinov3_7b.single"]


def _cfg():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sam2l_dinov3_7b.json")) as f:
        return json.load(f)


def _reader(name):
    return load_module(os.path.join(ROOT, "portbench", "metrics",
                                    name + ".py"),
                       "v3_" + name.replace(".", "_"))


def test_image_flops_against_flop_counter():
    """DINOv3-7B at 592^2 and Hiera-L + FPN at 1024^2 counted by torch's
    FLOP counter over the reference, on the meta-device weights of the
    modules that the program's matcher builds; the decode and the scoring
    as the flagship's (held to the counter by test_portbench_counts):
    24.95 TFLOP an image, 19.69 in the encoder (79 %)."""
    cfg = _cfg()
    t = cfg["topology"]
    sam2_sd, dino_sd = _meta_weights(cfg)
    dino = _meta_sd(models.dino_features, dino_sd, t["dino"],
                    torch.empty(1, 592, 592, 3, device="meta"))
    hiera = _meta_sd(models.image_encoder, sam2_sd, t["hiera"],
                     torch.empty(1, 1024, 1024, 3, device="meta"))
    assert dino == common.dino_flops(t["dino"])
    assert hiera == common.hiera_flops(t["hiera"])
    p = cfg["matching"]["points_per_side"] ** 2
    rest = common.decoder_flops(t["decoder"], 1024, p) + common.scoring_flops(
        t["dino"], 1024, p, cfg["bank"]["classes"])
    total = counts.image_flops(cfg)
    assert total == dino + hiera + rest
    assert round(total / 1e12, 2) == 24.95
    assert round(dino / 1e12, 2) == 19.69
    assert 0.78 < dino / total < 0.80


def test_work_at_the_7b_shapes():
    """By hand, bf16 (2 bytes a value), n = 37^2 + 5 = 1374 tokens:
      - MLP: 6 x 1374 x 4096 x 8192 = 276.6 G operations (0.2797 ms at
        989 TFLOP/s); bytes 3 x 4096 x 8192 weights + 2 x 8192 + 4096
        biases + 2 x 1374 x 4096 activations = 111.9 M values (0.0668 ms):
        bound by operations;
      - RoPE on one of q or k: 1369 patch rows x 4096 values read and
        written: 22.4 MB, 6.70 us;
      - kernel 9, DINOv3: 4 x 32 x 1374^2 x 128 = 30.93 G operations
        (31.3 us), q, k, v and the output 45.0 MB (13.4 us): bound by
        operations; Hiera-L's global block [1, 4096, 8, 72]: 38.65 G;
      - K1 at [1374, 4096]: 2 x 1374 x 4096 + 2 x 4096 values, 22.5 MB,
        6.72 us."""
    ops, nbytes = counts.mlp_call(1374, 4096, 8192, True)
    assert ops == 6 * 1374 * 4096 * 8192 == 276_622_737_408
    assert nbytes == 2 * (3 * 4096 * 8192 + 2 * 8192 + 4096
                          + 2 * 1374 * 4096)
    assert round(ops / 989e12 * 1e3, 4) == 0.2797
    assert round(nbytes / 3.35e12 * 1e3, 4) == 0.0668
    ops, nbytes = counts.mlp_call(1374, 4096, 16384, False)
    assert ops == 4 * 1374 * 4096 * 16384
    assert nbytes == 2 * (2 * 4096 * 16384 + 16384 + 4096 + 2 * 1374 * 4096)
    assert counts.rope_call(1369, 4096) == (0, 2 * 2 * 1369 * 4096)
    assert round(2 * 2 * 1369 * 4096 / 3.35e12 * 1e6, 2) == 6.70
    ops, nbytes = counts.attn_call(1, 1374, 1374, 32, 128)
    assert ops == 4 * 32 * 1374 ** 2 * 128
    assert round(ops / 1e9, 2) == 30.93
    assert nbytes == 2 * 4 * 1374 * 32 * 128
    assert round(ops / 989e12 * 1e6, 1) == 31.3
    assert counts.attn_call(1, 4096, 4096, 8, 72)[0] == 38_654_705_664
    ops, nbytes = counts.norm_call(1374, 4096)
    assert ops == 0 and nbytes == 2 * (2 * 1374 * 4096 + 2 * 4096)
    assert round(nbytes / 3.35e12 * 1e6, 2) == 6.72


def test_config_file_agrees():
    """The file names the 7B preset at its published widths, Hiera-L as
    the flagship, the 1-shot bank at the encoder's input size, and its
    cuts; `test_config_files_agree`'s checks hold for it."""
    cfg = _cfg()
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        entry = [c for c in json.load(f)["configs"]
                 if c["name"] == "sam2l_dinov3_7b"][0]
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"] == ["weights", "images",
                                                  "memory_bank"]
    assert cfg["program"] == {"sam2_cfg": "sam2_hiera_l.yaml",
                              "encoder_cfg": "dinov3_7b"}
    assert cfg["topology"]["dino"] == {
        "family": "dinov3", "img_size": 592, "patch_size": 16, "dim": 4096,
        "depth": 40, "heads": 32, "registers": 4, "mlp_hidden": 8192,
        "gated": True, "act": "silu", "rope_theta": 100.0, "eps": 1e-5}
    assert cfg["bank"] == {"classes": 20, "shots": 1, "ref_size": 592}
    with open(os.path.join(ROOT, "portbench", "configs",
                           "sam2l_dinov2l.json")) as f:
        flagship = json.load(f)
    for key in ("hiera", "decoder"):
        assert cfg["topology"][key] == flagship["topology"][key]
    assert cfg["matching"] == flagship["matching"]
    encoder_agrees(cfg)


def test_cell_resolves_with_its_readers():
    cell = Cell(CELL)
    assert cell.chips == 1 and cell.traffic["loop"] == "closed"
    assert sorted(cell.readers) == sorted(READERS)
    assert [m["name"] for m in cell.end_to_end] == [
        "image_ms_p50", "peak_mem_gib", "setup_s"]


def test_ranges_the_program_lacks_are_left_out(monkeypatch):
    """On a program without `rope_patches` (the parent of this
    configuration's readers) the range is not installed."""
    import no_time_to_train_tpu_torch.models.dino_v3 as dv3
    where = ("function", "no_time_to_train_tpu_torch.models.dino_v3",
             "rope_patches")
    assert counts.present({"r": where}) == {"r": where}
    monkeypatch.delattr(dv3, "rope_patches")
    assert counts.present({"r": where}) == {}
    assert counts.present({"r": ("function", "no_such_module_here", "f")}) \
        == {}
    assert counts.present({"m": ("module", "dino")}) == {
        "m": ("module", "dino")}


def _run(ranges, kernels, calls=None, peak=None, finished=2):
    from portbench.harness.tracing import Trace
    from portbench.run import RunView
    trace = Trace([])
    trace.ranges, trace.kernels = ranges, kernels
    cell = SimpleNamespace(config={"matching": {"compute_dtype":
                                                "bfloat16"}})
    return RunView(cell, None, SimpleNamespace(finished=finished), trace,
                   calls or {}, peak, [])


@pytest.mark.parametrize("name", [r for r in READERS if not r.startswith(
    ("mfu.", "device.idle"))])
def test_readers_without_their_ranges_read_nothing(name):
    kernels = [("k", 10.0, 5.0, 3.0, 1)]
    assert _reader(name).read(_run({"pb.request": [(0.0, 50.0, 1)]},
                                   kernels)) is None


def test_layer_norm_roofline_reads_its_kernels():
    """The configuration's 81 calls a request of 22.5 MB each (6.72 us at
    3.35 TB/s); over two requests whose K1 kernels took 10 us a call
    inside the encoder's forward: 67.2 %. A kernel of another name in the
    range is not K1's, nor a K1 kernel launched outside it."""
    peak = {"bfloat16": 989e12, "bytes_per_s": 3.35e12}
    call = counts.norm_call(1374, 4096)
    ranges = {"pb.dinov3": [(0.0, 500.0, 1), (1000.0, 1500.0, 1)]}
    kernels = [("void ln_wide_kernel<4>(...)", 2000.0 + i, 10.0,
                1.0 + i + 1000.0 * (i >= 81), 1) for i in range(162)]
    kernels += [("elementwise_kernel", 3000.0, 50.0, 22.0, 1),
                ("void ln_wide_kernel<4>(...)", 3100.0, 10.0, 600.0, 1)]
    run = _run(ranges, kernels, peak=peak)
    run.cell.config = _cfg()
    share = _reader("dinov3.layer_norm_roofline").read(run)
    assert share == pytest.approx(100 * call[1] / 3.35e12 / 10e-6)
    assert round(share, 1) == 67.2
