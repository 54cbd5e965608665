"""The policy of `ops/graph_call.GraphSite` on the CPU, with a stand-in for
the CUDA graph whose replay runs the captured function on the static
inputs: capture on a key's second consecutive call, one live graph per
site, eager calls for alternating keys, returned tensors that never alias
a static buffer, launch counters that count each call once, a graph
dropped after a write to a table's source; and the DINOv2, grid-decode
and image-encoder sites of the tiny models, which on the CPU run the eager
code unchanged, and through the stand-in give the same bits, also after
their weights are written, with no per-prompt image-side tensor in a
decode graph and no 256-channel high-resolution level in the image
encoder's; and the video predictor's chunked scan, whose graph goes through
the same capture: the scanned run through the stand-in gives the eager
scan's bits and counts its launches, and after a weight write, a load or a
move of the model the scan captures anew."""
import copy

import numpy as np
import pytest
import torch

from no_time_to_train_tpu_torch.config.presets import (
    EncoderConfig, Sam2Config)
from no_time_to_train_tpu_torch.models.dino import DinoV2
from no_time_to_train_tpu_torch.models.sam2.common import conv1x1
from no_time_to_train_tpu_torch.models.sam2.model import SAM2
from no_time_to_train_tpu_torch.models.sam2.video import SAM2VideoPredictor
from no_time_to_train_tpu_torch.ops import _cuda, graph_call
from no_time_to_train_tpu_torch.ops.graph_call import (
    GraphSite, _Captured, graph_stats)
from no_time_to_train_tpu_torch.ops.graph_inputs import held, holding
from no_time_to_train_tpu_torch.ops.upscale_product import no_fusion
from no_time_to_train_tpu_torch.utils.init import init_random_


class _StandIn:
    """A captured graph: `replay` runs `fn` on the static inputs and writes
    its outputs into the static outputs."""

    def __init__(self, fn, static_in, static_out):
        self.fn, self.static_in, self.static_out = fn, static_in, static_out

    def replay(self):
        with _cuda.recorded_launches():      # counted by _Captured.replay
            outs = self.fn(*self.static_in)
        outs = outs if isinstance(outs, tuple) else (outs,)
        for o, r in zip(self.static_out, outs):
            if o is not None:                # None: fn writes in place
                o.copy_(r)


def _stand_in_capture(fn, static_in, warm, device, key=None):
    """`graph_call.capture` on the CPU, with the real launch recording: the
    eager run on `warm`, dropped, then a stand-in graph of fn on
    `static_in`. A capture runs no kernel, so the stand-in's runs on a copy
    of `static_in`, which fn may write (the scan step moves its rings)."""
    with _cuda.recorded_launches():
        fn(*warm)
    with holding() as tables, _cuda.recorded_launches() as launches:
        static_out = fn(*copy.deepcopy(static_in))
    live = _Captured(key, None, static_in, static_out, tables, launches)
    live.graph = _StandIn(fn, static_in, live.static_out)
    return live, 0


@pytest.fixture(autouse=True)
def stand_in_capture(monkeypatch):
    """Every capture of this module is the stand-in's."""
    monkeypatch.setattr(graph_call, "capture", _stand_in_capture)


class StandInSite(GraphSite):
    """A site that takes the graph path on the CPU."""

    def _capturable(self, args):
        return not torch.is_grad_enabled()


LAUNCHES = {"k": 0}


def _fn(x, y):
    _cuda.count(LAUNCHES, "k")
    return x * 2 + y, (x - y).sum(-1)


def _site():
    return StandInSite("t", graph_stats())


def _args(seed, n=4):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, generator=g), torch.randn(n, 3, generator=g)


def _count(stats, what):
    return sum(stats[what].values())


@torch.no_grad()
def test_capture_on_second_consecutive_call():
    site = _site()
    for i in range(5):
        a = _args(i)
        got = site(_fn, *a)
        want = _fn(*a)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        seen = [_count(site.stats, w) for w in ("eager", "captures",
                                                "replays")]
        assert seen == [1, 0, 0] if i == 0 else (
            [1, 1, 0] if i == 1 else [1, 1, i - 1])
    assert site._live is not None


@torch.no_grad()
def test_one_graph_per_site_and_a_new_key_drops_it():
    site = _site()
    site(_fn, *_args(0))
    site(_fn, *_args(1))                      # captures key A
    first = site._live
    site(_fn, *_args(2, n=6))                 # key B: drops A, eager
    assert site._live is None
    site(_fn, *_args(3, n=6))                 # captures B
    assert site._live is not None and site._live is not first
    assert site._live.key[0][0] == ((6, 3), torch.float32)
    assert _count(site.stats, "captures") == 2
    assert len(site.stats["captures"]) == 2   # one entry per (site, key)


@torch.no_grad()
def test_alternating_keys_stay_eager():
    site = _site()
    for i in range(8):
        site(_fn, *_args(i, n=4 + i % 2))
    assert _count(site.stats, "captures") == 0
    assert _count(site.stats, "eager") == 8
    assert site._live is None


@torch.no_grad()
def test_the_site_key_and_no_fusion_are_part_of_the_key():
    site = _site()
    site(_fn, *_args(0), key=("a",))
    site(_fn, *_args(1), key=("b",))
    with no_fusion():
        site(_fn, *_args(2), key=("b",))
    assert _count(site.stats, "captures") == 0


@torch.no_grad()
def test_outputs_are_fresh_except_scratch():
    site = _site()
    for i in range(2):
        site(_fn, *_args(i))
    first = site(_fn, *_args(10))
    kept = [t.clone() for t in first]
    static = site._live.static_out
    for t in first:
        assert all(t.untyped_storage().data_ptr()
                   != s.untyped_storage().data_ptr() for s in static)
    site(_fn, *_args(11))
    assert all(torch.equal(t, k) for t, k in zip(first, kept))
    # a scratch output is the static buffer, valid until the next call
    out, _ = site(_fn, *_args(12), scratch=(0,))
    assert out.data_ptr() == static[0].data_ptr()
    assert torch.equal(out, _fn(*_args(12))[0])


@torch.no_grad()
def test_a_write_to_a_source_drops_the_graph():
    w = torch.arange(3.0)

    def fn(x):
        return x + held(w * 2, source=w)

    site = _site()
    x = torch.ones(4, 3)
    for _ in range(3):                        # eager, capture, replay
        site(fn, x)
    assert len(site._live.held.sources) == 1
    with torch.no_grad():
        w.add_(1)
    assert torch.equal(site(fn, x), x + w * 2)
    assert [_count(site.stats, k) for k in ("eager", "captures",
                                            "replays")] == [1, 2, 1]
    site(fn, x)
    assert _count(site.stats, "replays") == 2


@torch.no_grad()
def test_launch_counters_count_each_call_once():
    site = _site()
    before = LAUNCHES["k"]
    for i in range(5):
        site(_fn, *_args(i))
    assert LAUNCHES["k"] - before == 5


def test_grad_mode_stays_eager():
    site = _site()
    for i in range(3):
        site(_fn, *_args(i))
    assert _count(site.stats, "eager") == 0 and site._live is None


def test_a_copied_module_starts_without_a_graph():
    site = _site()
    with torch.no_grad():
        for i in range(2):
            site(_fn, *_args(i))
    owner = {"stats": site.stats, "site": site}
    twin = copy.deepcopy(owner)
    assert twin["site"]._live is None and twin["site"]._last is None
    assert twin["site"].stats is twin["stats"]
    assert twin["stats"] == site.stats and twin["stats"] is not site.stats


SAM_CFG = Sam2Config(
    embed_dim=32, num_heads=1, stages=(1, 1, 1, 1), global_att_blocks=(2,),
    window_pos_embed_bkg_spatial_size=(2, 2), window_spec=(4, 2, 4, 2),
    backbone_channel_list=(256, 128, 64, 32), image_size=128)
DINO_CFG = EncoderConfig("tiny", 28, 14, 32, 2, 2, "local")


@pytest.fixture(scope="module")
def models():
    sam2, dino = SAM2(SAM_CFG), DinoV2(DINO_CFG)
    init_random_(sam2, torch.Generator().manual_seed(0))
    init_random_(dino, torch.Generator().manual_seed(1))
    return sam2.eval(), dino.eval()


def _decode_inputs(seed, n=16):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(1, 8, 8, 256, generator=g)
    hr = [torch.randn(1, 32, 32, 32, generator=g),
          torch.randn(1, 16, 16, 64, generator=g)]
    pts = torch.rand(n, 1, 2, generator=g) * 128
    return feats, pts, torch.ones(n, 1, dtype=torch.long), hr


def _decode_before(sam2, feats, pts, labels, hr):
    """The grid decode as one `predict_best_of_multimask` call."""
    pe = sam2.sam_prompt_encoder
    sparse = pe.embed_points(pts, labels).repeat(feats.shape[0], 1, 1)
    return sam2.sam_mask_decoder.predict_best_of_multimask(
        feats, pe.get_dense_pe(), sparse, pe.no_mask_dense(),
        high_res_features=hr)


@pytest.mark.parametrize("site", ["cpu", "stand-in"])
@torch.no_grad()
def test_sites_equal_the_eager_path(models, site):
    """Four calls on distinct inputs: through the real site (eager on the
    CPU, no counter moves) or the stand-in (eager, capture, two replays),
    each bit for bit the eager code, and each result unchanged by the
    calls after it."""
    sam2, dino = models
    if site == "stand-in":
        sam2, dino = _stand_in(sam2, dino)
    kept = []
    for i in range(4):
        imgs = torch.randn(1, 28, 28, 3,
                           generator=torch.Generator().manual_seed(i))
        feats = dino(imgs)
        assert torch.equal(feats, dino._features(imgs, True))
        args = _decode_inputs(i)
        mask, iou = sam2.forward_sam_heads_best(*args)
        want = _decode_before(sam2, *args)
        assert torch.equal(mask, want[0]) and torch.equal(iou, want[1])
        kept.append([(t, t.clone()) for t in (feats, mask, iou)])
    # another key: the CLS token kept
    assert torch.equal(dino(imgs, drop_prefix_tokens=False),
                       dino._features(imgs, False))
    for held in kept:
        assert all(torch.equal(t, c) for t, c in held)
    if site == "cpu":
        assert all(not v for v in sam2.graph_stats.values())
        assert all(not v for v in dino.graph_stats.values())
    else:
        steps = len(sam2._decode_graphs)
        for st, eager, n in ((dino.graph_stats, 2, 1),
                             (sam2.graph_stats, 1, steps)):
            assert [_count(st, w) for w in ("eager", "captures",
                                            "replays")] == [
                eager * n, n, 2 * n]
        # each decode graph holds token-side tensors only: none is as large
        # as the tokens of every prompt ([B, N, C])
        tokens = sam2._decode_graphs["prompts"]._live.static_out[0]
        for site in sam2._decode_graphs.values():
            for t in site._live.static_in + site._live.static_out:
                assert t.numel() <= tokens.numel()


def _stand_in(sam2, dino):
    sam2, dino = copy.deepcopy(sam2), copy.deepcopy(dino)
    sam2._decode_graphs = {n: StandInSite(f"decode.{n}", sam2.graph_stats)
                           for n in sam2._decode_graphs}
    dino._graph = StandInSite("dino", dino.graph_stats)
    return sam2, dino


@torch.no_grad()
def test_weights_written_after_a_capture_give_fresh_results():
    """W8A8 DINOv2 through the stand-in: after a capture, weights written in
    place (the levels' source) and then loaded from a state dict each give
    the eager code's result on the new weights, through a new capture."""
    dino = DinoV2(DINO_CFG, quant="int8")
    init_random_(dino, torch.Generator().manual_seed(2))
    dino.eval()
    dino._graph = StandInSite("dino", dino.graph_stats)
    imgs = torch.randn(1, 28, 28, 3,
                       generator=torch.Generator().manual_seed(3))
    for _ in range(3):
        dino(imgs)
    assert _count(dino.graph_stats, "captures") == 1
    assert len(dino._graph._live.held.sources) > 0
    fc1 = dino.encoder.layer[0].mlp.fc1.weight
    fc1.mul_(1.5)
    assert torch.equal(dino(imgs), dino._features(imgs, True))
    assert _count(dino.graph_stats, "captures") == 2
    state = {k: v * 0.5 for k, v in dino.state_dict().items()}
    dino.load_state_dict(state)
    assert dino._graph._live is None
    for _ in range(2):
        assert torch.equal(dino(imgs), dino._features(imgs, True))
    assert _count(dino.graph_stats, "captures") == 3


def _images(seed):
    return torch.randn(1, 128, 128, 3,
                       generator=torch.Generator().manual_seed(seed))


def _image_before(sam2, imgs):
    """`forward_image`'s levels as the eager trunk, neck and the decoder's
    conv_s0 / conv_s1 compute them."""
    enc, dec = sam2.image_encoder, sam2.sam_mask_decoder
    levels = enc.neck(enc.trunk(imgs))[:-enc.scalp]
    return [conv1x1(dec.conv_s0, levels[0]), conv1x1(dec.conv_s1, levels[1]),
            *levels[2:]]


def _image_stand_in(sam2):
    sam2.image_encoder._graph = StandInSite("image", sam2.graph_stats)
    return sam2


def _same_levels(sam2, imgs):
    out = sam2.forward_image(imgs)
    fpn = out["backbone_fpn"]
    assert out["vision_features"] is fpn[-1]
    want = _image_before(sam2, imgs)
    assert len(fpn) == len(want)
    assert all(torch.equal(g, w) for g, w in zip(fpn, want))
    return fpn


@pytest.mark.parametrize("site", ["cpu", "stand-in"])
@torch.no_grad()
def test_image_site_equals_the_eager_path(models, site):
    """`forward_image` on four distinct inputs: through the real site (eager
    on the CPU, no counter moves) or the stand-in (one eager call, one
    capture, two replays), each bit for bit the eager trunk, neck and
    convolutions, each result unchanged by the calls after it and sharing
    no storage with the graph's buffers, and a forward pre-hook on the image
    encoder fired on every call. The graph's static outputs are the three
    levels the callers read: no 256-channel level 0 or 1 is held."""
    sam2 = models[0]
    if site == "stand-in":
        sam2 = _image_stand_in(copy.deepcopy(sam2))
    calls = []
    hook = sam2.image_encoder.register_forward_pre_hook(
        lambda _mod, _args: calls.append(len(calls)))
    kept = []
    try:
        for i in range(4):
            kept += [(t, t.clone()) for t in _same_levels(sam2, _images(i))]
    finally:
        hook.remove()
    assert len(calls) == 4
    assert all(torch.equal(t, c) for t, c in kept)
    stats = sam2.graph_stats
    if site == "cpu":
        assert all(not v for v in stats.values())
        return
    assert [_count(stats, w) for w in ("eager", "captures", "replays")] \
        == [1, 1, 2]
    assert {k[0] for w in ("eager", "captures", "replays")
            for k in stats[w]} == {"image"}
    live = sam2.image_encoder._graph._live
    assert [tuple(t.shape) for t in live.static_out] == [
        (1, 32, 32, 32), (1, 16, 16, 64), (1, 8, 8, 256)]
    static = {t.untyped_storage().data_ptr()
              for t in live.static_in + live.static_out}
    assert all(t.untyped_storage().data_ptr() not in static for t, _ in kept)


@pytest.mark.parametrize("write", ["conv_s0", "load_state_dict", "int8",
                                   "decoder.to"])
@torch.no_grad()
def test_image_site_after_a_weight_write(write):
    """After a capture through the stand-in, each gives the eager code's
    levels on the new weights: conv_s0's weight written in place is read
    by the next replay at its address (no new capture); `load_state_dict`
    on SAM2 drops the graph, so the next two calls run eagerly and capture
    anew; under W8A8 a trunk weight written in place is the source of
    levels the graph holds, so the next call captures anew; the mask
    decoder moved alone gives conv_s0 / conv_s1 new addresses, which the
    key holds, so the next call runs eagerly and the one after captures."""
    sam2 = SAM2(SAM_CFG, encoder_quant="int8" if write == "int8" else "none")
    init_random_(sam2, torch.Generator().manual_seed(4))
    sam2 = _image_stand_in(sam2.eval())
    imgs = _images(5)
    for _ in range(3):                        # eager, capture, replay
        _same_levels(sam2, imgs)
    site = sam2.image_encoder._graph
    if write == "conv_s0":
        sam2.sam_mask_decoder.conv_s0.weight.mul_(1.5)
        want = (1, 1, 2)
    elif write == "load_state_dict":
        sam2.load_state_dict({k: v * 0.5
                              for k, v in sam2.state_dict().items()})
        assert site._live is None
        _same_levels(sam2, imgs)
        want = (2, 2, 1)
    elif write == "decoder.to":
        dec = sam2.sam_mask_decoder
        # the old parameters kept alive, so no new one takes their address
        old = [p.detach() for p in dec.parameters()]
        dec.to(torch.float64).to(torch.float32)
        assert site._live is not None and len(old) > 0
        _same_levels(sam2, imgs)
        want = (2, 2, 1)
    else:
        assert len(site._live.held.sources) > 0
        sam2.image_encoder.trunk.blocks[0].mlp.layers[0].weight.mul_(1.5)
        want = (1, 2, 1)
    _same_levels(sam2, imgs)
    assert tuple(_count(sam2.graph_stats, w)
                 for w in ("eager", "captures", "replays")) == want


def _clip(n=9, seed=3):
    """n frames of 128^2 noise with a bright block moving to the right."""
    rng = np.random.default_rng(seed)
    frames = rng.random((n, 128, 128, 3)).astype(np.float32)
    for t in range(n):
        frames[t, 40:90, 10 + 3 * t:50 + 3 * t] = 0.9
    return frames


def _predictor(quant="none"):
    sam2 = SAM2(SAM_CFG, encoder_quant=quant)
    init_random_(sam2, torch.Generator().manual_seed(6))
    pred = SAM2VideoPredictor(sam2, device="cpu")
    pred.scan_chunk = 4
    return pred


def _scanned(pred, frames, graphed):
    """Frame 0 prompted, frames 1.. tracked by the chunked scan, through the
    stand-in graph or eagerly: the masks by frame."""
    pred._graphed = lambda: graphed
    try:
        state = pred.init_state(frames)
        pred.add_new_points_or_box(
            state, 0, 1, points=np.array([[30.0, 60.0]], np.float32),
            labels=np.array([1], np.int32))
        return {t: m.clone() for t, _, m in pred.propagate_in_video(state)}
    finally:
        del pred._graphed


def _same_masks(got, want):
    assert list(got) == list(want)
    assert all(torch.equal(got[t], want[t]) for t in want)


def _scan_counts(pred):
    stats = pred.model.graph_stats
    assert {k[0] for w in ("captures", "replays", "eager")
            for k in stats[w]} <= {"scan"}
    return tuple(_count(stats, w) for w in ("eager", "captures", "replays"))


@torch.no_grad()
def test_scan_graph_equals_the_eager_scan():
    """A scanned run through the stand-in gives the eager scan's masks bit
    for bit (its warm-up step wrote no live ring), one capture and one
    replay per tracked frame under the site "scan" of the model's
    `graph_stats`, and the eager run's launch counts: the warm-up and the
    capture count none, each replay its capture's."""
    pred = _predictor()
    launches = {"track": 0}
    track_core = pred._track_core
    pred._track_core = lambda *a: (_cuda.count(launches, "track"),
                                   track_core(*a))[1]
    frames = _clip()
    want = _scanned(pred, frames, False)
    eager = launches["track"]
    assert _scan_counts(pred) == (0, 0, 0) and eager >= len(frames) - 1
    got = _scanned(pred, frames, True)
    _same_masks(got, want)
    assert _scan_counts(pred) == (0, 1, len(frames) - 1)
    assert launches["track"] == 2 * eager
    assert all(k[1][0] == 1 for k in pred.model.graph_stats["replays"])


@pytest.mark.parametrize("write", ["int8", "load_state_dict", "to"])
@torch.no_grad()
def test_scan_graph_after_a_weight_write(write):
    """After a scanned run through the stand-in, each makes the next
    scanned run capture anew and give the eager scan's masks on the new
    weights: under W8A8 a trunk weight written in place (the source of
    levels the graph holds); `load_state_dict` and a move (`to`) of the
    predictor's model (its `graph_generation` moves on)."""
    pred = _predictor("int8" if write == "int8" else "none")
    frames = _clip()
    _scanned(pred, frames, True)
    live = next(iter(pred._scan_steps.values())).live
    model = pred.model
    if write == "int8":
        assert len(live.held.sources) > 0
        model.image_encoder.trunk.blocks[0].mlp.layers[0].weight.mul_(1.5)
        assert live.held.stale()
    elif write == "load_state_dict":
        model.load_state_dict({k: v * 0.5
                               for k, v in model.state_dict().items()})
    else:
        # the old parameters kept alive, so no new one takes their address
        old = [p.detach() for p in model.parameters()]
        model.to(torch.float64).to(torch.float32)
        assert old[0].data_ptr() != model.no_mem_embed.data_ptr()
    got = _scanned(pred, frames, True)
    assert _scan_counts(pred) == (0, 2, 2 * (len(frames) - 1))
    assert next(iter(pred._scan_steps.values())).live is not live
    _same_masks(got, _scanned(pred, frames, False))


@pytest.mark.parametrize("owner", ["dino", "image_encoder", "sam2"])
@torch.no_grad()
def test_owners_reset_their_sites_through_the_base(models, owner):
    """DinoV2, the image encoder and SAM2 define no reset of their own: the
    base's `_apply` and `_load_from_state_dict` drop every site's graph and
    key and move `graph_generation` on, once per move and once per load."""
    sam2, dino = _stand_in(*models)
    _image_stand_in(sam2)
    mod = {"dino": dino, "image_encoder": sam2.image_encoder,
           "sam2": sam2}[owner]
    assert isinstance(mod, graph_call.GraphOwner)
    assert not {"_apply", "_load_from_state_dict"} & set(vars(type(mod)))
    sites = ([mod._graph] if owner != "sam2"
             else list(mod._decode_graphs.values()))
    for i in range(2):
        for site in sites:
            site._last = site._live = object()
        gen = mod.graph_generation
        if i == 0:
            mod.to(torch.float32)
        else:
            mod.load_state_dict(mod.state_dict())
        assert mod.graph_generation == gen + 1
        assert all(s._live is None and s._last is None for s in sites)
