"""The image encoder's CUDA graph site on the card (marked `cuda`, skipped
without one; run with `python -m pytest -m cuda
tests/test_torch_graph_call_cuda.py` on a machine with an NVIDIA GPU): a
small SAM2 in bf16 under `pallas` at 256^2, with Hiera-L's widths (kernel 10
over the 64 stage-1 windows, kernel 9 at a global block of 1024 tokens, K1)
and one block or two a stage. Its `forward_image` runs eagerly on the first
call, captures a real CUDA graph on the second and replays it from the
third; the levels match the eager code (bit for bit where cuBLAS picks the
same algorithm under the graph's own workspace, else within bf16 rounding),
no returned tensor shares storage with the graph's buffers, the kernels'
launch counters count each call once, and a weight written in place is read
by the next replay at its address. The same model under W8A8 in the video
predictor: the chunked scan's graph (site "scan"), after a trunk weight
written in place and after a move of the model, captured anew and within
bf16 rounding of the per-frame path. No JAX here: the eager code is the
reference."""
import numpy as np
import pytest
import torch

from no_time_to_train_tpu_torch.config.presets import Sam2Config
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2.video import SAM2VideoPredictor
from no_time_to_train_tpu_torch.ops import flash_attention as fa
from no_time_to_train_tpu_torch.ops import fused_ln as fl
from no_time_to_train_tpu_torch.utils.init import init_random_

pytestmark = pytest.mark.cuda

CFG = Sam2Config(
    embed_dim=144, num_heads=2, stages=(1, 2, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(7, 7), window_spec=(8, 4, 16, 8),
    backbone_channel_list=(1152, 576, 288, 144), image_size=256)
REL = 1e-2          # bf16 rounding: the relative L2 error a result may read


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _launches():
    return (fa.LAUNCHES["flash_sdpa_window_qkv"],
            fa.LAUNCHES["flash_sdpa_bnhd"], fl.LAUNCHES["layer_norm"])


def _eager(sam2, imgs):
    dec = sam2.sam_mask_decoder
    return list(sam2.image_encoder._levels(imgs, (dec.conv_s0, dec.conv_s1)))


def _close(got, want, dtype=torch.bfloat16):
    assert [t.shape for t in got] == [t.shape for t in want]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == dtype
        rel = ((g.float() - w.float()).norm() / w.float().norm()).item()
        assert rel <= REL, rel


@torch.no_grad()
def test_forward_image_replays_a_graph(dev):
    sam2 = SAM2(CFG)
    init_random_(sam2, torch.Generator().manual_seed(0))
    sam2 = sam2.to(dev, torch.bfloat16).eval()
    site = sam2.image_encoder._graph
    g = torch.Generator(device=dev).manual_seed(1)
    imgs = [torch.randn(1, 256, 256, 3, generator=g, device=dev)
            .bfloat16() for _ in range(4)]
    per_call = None
    kept = []
    for i, x in enumerate(imgs):
        before = _launches()
        fpn = sam2.forward_image(x)["backbone_fpn"]
        moved = tuple(a - b for a, b in zip(_launches(), before))
        per_call = per_call or moved
        assert moved == per_call and all(moved), (i, moved)
        kept.append((fpn, [t.clone() for t in fpn]))
    torch.cuda.synchronize(dev)
    stats = sam2.graph_stats
    assert [sum(stats[w].values()) for w in ("eager", "captures",
                                             "replays")] == [1, 1, 2]
    live = site._live
    assert isinstance(live.graph, torch.cuda.CUDAGraph)
    assert [tuple(t.shape) for t in live.static_out] == [
        (1, 64, 64, 32), (1, 32, 32, 64), (1, 16, 16, 256)]
    static = {t.untyped_storage().data_ptr()
              for t in live.static_in + live.static_out}
    for x, (fpn, copies) in zip(imgs, kept):
        assert all(t.untyped_storage().data_ptr() not in static for t in fpn)
        assert all(torch.equal(t, c) for t, c in zip(fpn, copies))
        _close(fpn, _eager(sam2, x))

    # a weight written in place: the replay reads it at its address
    sam2.sam_mask_decoder.conv_s0.weight.mul_(1.5)
    fpn = sam2.forward_image(imgs[0])["backbone_fpn"]
    assert sum(stats["captures"].values()) == 1
    assert sum(stats["replays"].values()) == 3
    _close(fpn, _eager(sam2, imgs[0]))
    assert not torch.equal(fpn[0], kept[0][1][0])


def _clip(n=9):
    """n frames of 256^2 noise with a bright block moving to the right."""
    rng = np.random.default_rng(3)
    frames = rng.random((n, 256, 256, 3), np.float32) * 0.3
    for t in range(n):
        frames[t, 80:180, 20 + 6 * t:100 + 6 * t] = 0.9
    return frames


def _track(pred, frames, chunk):
    """Frame 0 prompted, the rest tracked by the chunked scan (chunk > 0)
    or frame by frame (0): the masks of every frame."""
    pred.scan_chunk = chunk
    state = pred.init_state(frames)
    pred.add_new_points_or_box(state, 0, 1, points=[[60.0, 130.0]],
                               labels=np.array([1], np.int32))
    return [m for _, _, m in pred.propagate_in_video(state)]


def _scan_stats(stats):
    return [sum(v for k, v in stats[w].items() if k[0] == "scan")
            for w in ("eager", "captures", "replays")]


@torch.no_grad()
def test_scan_graph_after_a_weight_write_and_a_move(dev):
    """The W8A8 model in bf16 in the video predictor: a scanned run
    captures a real CUDA graph (site "scan") and replays it once a tracked
    frame; after a trunk weight written in place, and after
    `predictor.model.to(...)`, the next scanned run captures anew. Each
    scanned run gives the per-frame path's masks within bf16 rounding."""
    sam2 = SAM2(CFG, encoder_quant="int8")
    init_random_(sam2, torch.Generator().manual_seed(0))
    pred = SAM2VideoPredictor(sam2.to(torch.bfloat16), device=dev)
    frames = _clip()
    tracked = len(frames) - 1
    stats = pred.model.graph_stats
    _close(_track(pred, frames, 4), _track(pred, frames, 0), torch.float32)
    assert _scan_stats(stats) == [0, 1, tracked]
    live = next(iter(pred._scan_steps.values())).live
    assert isinstance(live.graph, torch.cuda.CUDAGraph)
    assert len(live.held.sources) > 0

    # a W8A8 trunk weight written in place: the levels the graph holds
    pred.model.image_encoder.trunk.blocks[0].mlp.layers[0].weight.mul_(1.5)
    _close(_track(pred, frames, 4), _track(pred, frames, 0), torch.float32)
    assert _scan_stats(stats) == [0, 2, 2 * tracked]

    # every weight moved to a new address (the old ones kept alive, so that
    # no new one takes an old address)
    old = [p.detach() for p in pred.model.parameters()]
    pred.model.to(torch.float32).to(torch.bfloat16)
    assert old[0].data_ptr() != next(pred.model.parameters()).data_ptr()
    _close(_track(pred, frames, 4), _track(pred, frames, 0), torch.float32)
    assert _scan_stats(stats) == [0, 3, 3 * tracked]
