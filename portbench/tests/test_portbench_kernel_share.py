"""The kernel rooflines that read the device time of kernels by name inside
a layer's range, with each request's calls from the configuration
(`RunView.kernel_share`): `flash_sdpa_window_qkv_roofline` (kernel 10),
`fused_post_t1_roofline` (K4), `dinov3.flash_sdpa_bnhd_roofline` (kernel 9)
and `dinov3.layer_norm_roofline` (K1).

  - The configuration's call lists equal, in order, the calls that the
    wrappers on the program's functions record in a traced run of tiny
    cells on the CPU, and the cells' own configurations give the counts and
    shapes worked by hand.
  - A synthetic trace: the kernels of a CUDA graph replay inside the range
    are read, by name, template arguments and grid, as the same kernels
    launched one by one.
  - The names and values that the patterns rely on are those of the CUDA
    sources.
  - On the card, a module whose forward replays a CUDA graph of kernel 10
    and K1 calls is read, while the wrappers see no call.
"""
import json
import os
import re
from types import SimpleNamespace

import pytest
import torch

from conftest import (ROOT, add_cell, copy_bench, tiny_config,
                      tiny_dinov3_config)
from portbench.counts import common
from portbench.counts import sam2l_dinov3_7b as counts7b
from portbench.harness import kernels
from portbench.harness.cells import load_module
from portbench.harness.tracing import template_args

CSRC = os.path.join(ROOT, "no_time_to_train_tpu_torch", "csrc")
PEAK = {"bfloat16": 989e12, "float32": 67e12, "bytes_per_s": 3.35e12}
# metric -> (the range of its wrapper on the program's function, the
# configuration's calls of one request)
SHARES = {
    "flash_sdpa_window_qkv_roofline": ("pb.k.flash_sdpa_window_qkv",
                                       common.window_calls),
    "fused_post_t1_roofline": ("pb.k.fused_post_t1", common.upscale_calls),
    "dinov3.flash_sdpa_bnhd_roofline": ("pb.k.flash_sdpa_bnhd",
                                        counts7b.attn_calls),
    "dinov3.layer_norm_roofline": ("pb.k.dinov3_norm", counts7b.norm_calls),
}


def _reader(name):
    return load_module(os.path.join(ROOT, "portbench", "metrics",
                                    name + ".py"),
                       "ks_" + name.replace(".", "_"))


def _cfg(name):
    with open(os.path.join(ROOT, "portbench", "configs", name + ".json")) as f:
        return json.load(f)


def _tiny_hiera(cfg, name, window_spec):
    """`cfg` with a small Hiera at 512^2 (width 32, one head, stages
    1-2-3-2, block 4 global) whose blocks take every route of the
    program's attention: kernel 10 on windows of 16 x 16 (whole 128-row
    blocks) or 8 x 8, or padded windows of 14 x 14; kernel 9 on the global
    block's 1024 tokens; the plain formula below the gates."""
    hiera = {"embed_dim": 32, "num_heads": 1, "stages": [1, 2, 3, 2],
             "global_att_blocks": [4], "window_spec": window_spec,
             "backbone_channel_list": [256, 128, 64, 32]}
    cfg["name"] = name
    cfg["program"]["sam2_overrides"] = dict(hiera, image_size=512)
    cfg["topology"]["hiera"].update(hiera, image_size=512)
    return cfg


def _tiny_configs():
    big_l = _tiny_hiera(tiny_config(), "tiny_l", [16, 8, 16, 8])
    big_s = _tiny_hiera(tiny_config(), "tiny_s", [8, 14, 14, 7])
    # DINOv3 at 368^2: 23^2 patches + 5 tokens = 534, past kernel 9's gate
    v3 = _tiny_hiera(tiny_dinov3_config("gated"), "tiny_v3", [16, 8, 16, 8])
    v3["program"]["encoder_overrides"]["img_size"] = 368
    v3["topology"]["dino"]["img_size"] = 368
    v3["bank"]["ref_size"] = 368
    return [big_l, big_s, v3]


@pytest.fixture(scope="module")
def routes_root(tmp_path_factory):
    dst = str(tmp_path_factory.mktemp("routes_bench"))
    copy_bench(dst)
    for cfg in _tiny_configs():
        add_cell(dst, cfg)
    return dst


@pytest.mark.parametrize("cell,shares", [
    ("tiny_l.single", ["flash_sdpa_window_qkv_roofline",
                       "fused_post_t1_roofline"]),
    ("tiny_s.single", ["flash_sdpa_window_qkv_roofline",
                       "fused_post_t1_roofline"]),
    ("tiny_v3.single", list(SHARES))])
def test_configuration_lists_equal_the_calls(routes_root, torch_threads,
                                             cell, shares):
    """A traced segment of a tiny cell with the wrappers installed: each
    share's calls, recorded from the operands, are the configuration's
    list once for every request, in order."""
    from portbench import run
    from portbench.harness.cells import Cell
    device = torch.device("cpu")
    c = Cell(cell, root=routes_root,
             bench=os.path.join(routes_root, "portbench"))
    _, matcher, traffic, _ = run._setup(c, 5, device, None, lambda: None)
    segment, _, calls = run._traced_segment(c, matcher, traffic, device)
    assert segment.finished == c.traffic["trace_requests"]
    for name in shares:
        seen, per_request = SHARES[name]
        want = per_request(c.config)
        assert want, name
        assert calls[seen] == want * segment.finished, name


def test_tiny_routes_take_every_path():
    """The tiny Hiera-L-like blocks: kernel 10 at stage 1 (64 windows of
    256) and stage 2 (64 of 64), kernel 9 on the global block, the rest
    plain; Hiera-S-like: stage 2's windows of 14 padded to 5 x 5 windows
    of 196."""
    big_l, big_s, v3 = _tiny_configs()
    assert [k for k, _ in common.hiera_attention(big_l)] == [
        "window", None, "window", None, "bnhd", None, None, None]
    assert common.hiera_attention(big_l)[0][1] == (16384, 32, 256)
    assert common.hiera_attention(big_l)[4][1] == (1, 1024, 1024, 4, 32)
    assert common.hiera_attention(big_s)[2] == ("window", (4900, 64, 196))
    assert len(counts7b.attn_calls(v3)) == 4 + 1
    assert counts7b.attn_calls(v3)[0] == counts7b.attn_call(
        1, 534, 534, 3, 64, 4)


def test_cells_by_hand():
    """The cells' configurations, one request: kernel 10 on Hiera-L's 2
    stage-1 blocks (65536 tokens of width 144, windows of 64), 5 stage-2
    (16384, 288, 16) and 32 stage-3 (4096, 576, 256), 39 calls; on
    Hiera-S's 1, 1 and 7 at stage 3 (4900 padded tokens, 384, 196), 9; K4 on
    4 chunks of 256 prompts at 4096 tokens of 256; on the 7B, kernel 9 on
    DINOv3's 40 layers at [1, 1374, 32, 128], then Hiera-L's 3 global blocks
    at [1, 4096, 8, 72], and K1 on 81 norms of [1374, 4096]."""
    w = common.window_call
    big, small, v3 = (_cfg("sam2l_dinov2l"), _cfg("sam2s_dinov2l"),
                      _cfg("sam2l_dinov3_7b"))
    assert common.window_calls(big) == common.window_calls(v3) == (
        [w(65536, 144, 64)] * 2 + [w(16384, 288, 16)] * 5
        + [w(4096, 576, 256)] * 32)
    assert common.window_calls(small) == (
        [w(65536, 96, 64), w(16384, 192, 16)] + [w(4900, 384, 196)] * 7)
    for cfg in (big, small, v3):
        assert common.upscale_calls(cfg) == [
            common.upscale_call(256, 4096, 256)] * 4
    a = counts7b.attn_call
    assert counts7b.attn_calls(v3) == (
        [a(1, 1374, 1374, 32, 128)] * 40 + [a(1, 4096, 4096, 8, 72)] * 3)
    assert counts7b.norm_calls(v3) == [counts7b.norm_call(1374, 4096)] * 81


# --- a synthetic trace ------------------------------------------------------

K10_WINDOW = ("void attn_mma::attn_kernel<80, false, 2, 2, 2>(attn::Params, "
              "attn_mma::Split, attn_mma::Mask)")
PLAIN = ("void attn_mma::attn_kernel<80, false, 0, 4, 3>(attn::Params, "
         "attn_mma::Split, attn_mma::Mask)")
WG_PLAIN = ("void attn_mma::attn_wg_kernel<128, 2, false, 0>(attn::Params, "
            "attn_mma::Split, attn_mma::Mask)")
WG_SPLIT = ("void attn_mma::attn_wg_kernel<256, 2, true, 0>(attn::Params, "
            "attn_mma::Split, attn_mma::Mask)")
MERGE = ("attn_mma::merge_kernel(attn::Params, attn_mma::Split, int, "
         "long long)")
LN = ("void (anonymous namespace)::ln_wide_kernel<4>(__nv_bfloat16 const*, "
      "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16*, int, "
      "float)")
K4 = ("void (anonymous namespace)::post_t1_mma_kernel<false>(__nv_bfloat16 "
      "const*, __nv_bfloat16 const*, float const*)")
K5 = K4.replace("<false>", "<true>")

# (name, grid, range it is launched in or None, start, duration): one
# request's device work
KERNELS = [
    (K10_WINDOW, [512, 2, 1], "pb.hiera", 100.0, 20.0),   # kernel 10
    (PLAIN, [2, 8, 16], "pb.hiera", 130.0, 30.0),         # kernel 10
    (PLAIN, [32, 8, 1], "pb.hiera", 170.0, 50.0),         # kernel 9
    (MERGE, [100, 1, 1], "pb.hiera", 230.0, 3.0),         # kernel 9
    (K4, [132, 1, 1], "pb.decode", 240.0, 40.0),
    (K5, [132, 1, 1], "pb.decode", 290.0, 35.0),          # not K4's call
    (WG_PLAIN, [11, 32, 1], "pb.dinov3", 330.0, 60.0),    # kernel 9
    (K10_WINDOW, [512, 2, 1], "pb.dinov3", 400.0, 7.0),   # kernel 10's name
    (LN, [1374, 1, 1], "pb.dinov3", 410.0, 9.0),
    (PLAIN, [2, 8, 16], None, 430.0, 11.0),               # outside
    (PLAIN, [32, 8, 1], None, 445.0, 13.0),               # outside
    (LN, [1374, 1, 1], None, 460.0, 5.0),                 # outside
]
RANGES = {"pb.hiera": (50.0, 95.0), "pb.decode": (96.0, 99.0),
          "pb.dinov3": (0.0, 40.0)}


def _raw(graph):
    """Chrome trace events of the request: each range's kernels from one
    `cudaGraphLaunch` in it (`graph`) or each from its own
    `cudaLaunchKernel`; kernels outside every range launched between
    them."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": n, "ts": s,
           "dur": e - s, "tid": 1} for n, (s, e) in RANGES.items()]
    for i, (name, grid, rng, start, dur) in enumerate(KERNELS):
        corr = 1000 + (list(RANGES).index(rng) if graph and rng else i)
        if rng is None:
            at = 45.0 + 0.1 * i
        else:
            at = RANGES[rng][0] + (1.0 if graph else 1.0 + 0.1 * i)
        if not graph or rng is None or not any(
                e.get("args", {}).get("correlation") == corr for e in ev):
            ev.append({"ph": "X", "cat": "cuda_runtime",
                       "name": "cudaGraphLaunch" if graph and rng
                       else "cudaLaunchKernel", "ts": at, "dur": 0.5,
                       "tid": 1, "args": {"correlation": corr}})
        ev.append({"ph": "X", "cat": "kernel", "name": name, "ts": start,
                   "dur": dur, "tid": 7,
                   "args": {"correlation": corr, "grid": grid}})
    return {"traceEvents": ev}


def _view(raw, config, finished=1):
    from portbench.harness.tracing import Trace
    from portbench.run import RunView
    return RunView(SimpleNamespace(config=config), None,
                   SimpleNamespace(finished=finished), Trace(raw), {}, PEAK,
                   [])


@pytest.mark.parametrize("graph", [True, False])
def test_replayed_kernels_are_read(graph):
    """Inside the ranges: kernel 10 takes its kWindow launch and its plain
    launch over 16 windows; kernel 9 the plain launches over one batch
    element and the merge; K1 its wide kernel; K4 `post_t1_mma_kernel
    <false>`. Neither kernel 9 nor kernel 10 takes the other's, nor a
    launch outside the ranges."""
    trace = _view(_raw(graph), {})
    if graph:
        assert len({c for c in trace.trace.kernels if c[3] is not None}) \
            == len(KERNELS)
    us = trace.trace.device_us
    assert us(["pb.hiera"], kernels.window_qkv) == 20.0 + 30.0
    assert us(["pb.dinov3"], kernels.window_qkv) == 7.0
    assert us(["pb.dinov3", "pb.hiera"], kernels.bnhd) == 50.0 + 3.0 + 60.0
    assert us(["pb.decode"], _reader("fused_post_t1_roofline").k4) == 40.0
    assert us(["pb.dinov3"], _reader("dinov3.layer_norm_roofline").k1) \
        == 9.0
    assert us(["pb.request"], kernels.bnhd) == 0.0
    assert kernels.bnhd(MERGE, [100, 1, 1])
    assert not kernels.window_qkv(MERGE, [100, 1, 1])
    assert kernels.bnhd(WG_SPLIT, [44, 1, 1])
    assert not kernels.window_qkv(WG_SPLIT, [44, 1, 16])


def test_share_of_a_replay_equals_the_eager_form():
    """The share of each of the four readers on the graph form of the
    trace equals that on the eager form, with the configuration's calls."""
    cfg = _cfg("sam2l_dinov3_7b")
    graph, eager = _view(_raw(True), cfg, 2), _view(_raw(False), cfg, 2)
    for name in SHARES:
        r = _reader(name)
        a, b = r.read(graph), r.read(eager)
        assert a is not None and a == pytest.approx(b, rel=1e-12), name
    # kernel 10's share by hand: 2 requests of 39 calls over 50 us
    least = sum(max(o / PEAK["bfloat16"], b / PEAK["bytes_per_s"])
                for o, b in common.window_calls(cfg)) * 2
    assert _reader("flash_sdpa_window_qkv_roofline").read(graph) == \
        pytest.approx(100 * least / 50e-6)


def test_notes_set_the_calls_seen_beside_the_configuration():
    """Where the wrapper counted calls, the notes give their number
    against the configuration's and the share from them; with none seen
    (a replay) the note says so and the reading stands."""
    cfg = _cfg("sam2l_dinov3_7b")
    view = _view(_raw(False), cfg, 1)
    view.calls = {"pb.k.dinov3_norm": counts7b.norm_calls(cfg)}
    view.trace.ranges["pb.k.dinov3_norm"] = [(0.0, 40.0, 1)]
    share = _reader("dinov3.layer_norm_roofline").read(view)
    assert share is not None
    assert "81 calls seen against the configuration's 81 x 1 requests: " \
        "equal" in view.notes[-1]
    assert "(+0.000 %)" in view.notes[-1]
    view = _view(_raw(True), cfg, 1)
    assert _reader("dinov3.layer_norm_roofline").read(view) == \
        pytest.approx(share)
    assert "0 calls seen" in view.notes[-1]
    assert "unequal" in view.notes[-1]


@pytest.mark.parametrize("name,want", [
    (PLAIN, ("attn_mma::attn_kernel", ("80", "false", "0", "4", "3"))),
    (MERGE, ("attn_mma::merge_kernel", ())),
    (LN, ("{anonymous}::ln_wide_kernel", ("4",))),
    ("void at::native::vectorized_elementwise_kernel<4, "
     "at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, 3ul> >"
     "(int, at::native::CUDAFunctor_add<c10::BFloat16>, std::array<char*, "
     "3ul>)", ("at::native::vectorized_elementwise_kernel",
               ("4", "at::native::CUDAFunctor_add<c10::BFloat16>",
                "std::array<char*, 3ul>"))),
    ("Memcpy HtoD (Pageable -> Device)", ("Memcpy HtoD", ())),
])
def test_template_args(name, want):
    assert template_args(name) == want


# --- the CUDA sources -------------------------------------------------------

def _src(name):
    with open(os.path.join(CSRC, name)) as f:
        return f.read()


def test_patterns_follow_the_sources():
    """kPlain and kWindow as `attn_mma.cuh` defines them; the two tiles'
    template parameters in order, their grids (query tiles x splits, heads,
    batch); kernel 10's launches with SPLIT false and MODE kWindow, its
    whole-block windows on the plain entry with one split and the windows
    as the batch, and no merge; K1's and K4's kernels by name."""
    attn = _src("attn_mma.cuh")
    modes = re.search(r"constexpr int kPlain = (\d+), kBias = (\d+), "
                      r"kWindow = (\d+);", attn)
    assert (modes.group(1), modes.group(3)) == (kernels.K_PLAIN,
                                                kernels.K_WINDOW)
    for base, params in kernels.ATTN.items():
        kernel = base.split("::")[1]
        m = re.search(r"template <([^>]*)>\s*__global__ void "
                      r"__launch_bounds__\([^)]*\) " + kernel + r"\(", attn)
        names = [p.split("=")[0].split()[-1] for p in m.group(1).split(",")]
        assert tuple(names) == params, base
    assert len(re.findall(r"const dim3 grid\([^;]*, heads, batch\);",
                          attn)) == 2
    assert "merge_kernel(Params P" in attn
    window = _src("window_attn.cu")
    body = window[window.index('extern "C" int nttt_window_attn('):
                  window.index('extern "C" int nttt_window_attn_wmma(')]
    tiles = re.findall(r"launch_(?:wg_)?tile<([^>]*)>", body)
    assert tiles
    for args in tiles:
        args = [a.strip() for a in args.split(",")]
        assert "false" in args and "true" not in args and "kWindow" in args
    whole = body[body.index("if (win % 128 == 0"):]
    assert "return run(p, (int)windows, heads, 1, nullptr, nullptr, stream);" \
        in whole[:whole.index("}")]
    assert "merge" not in body
    ln = _src("layer_norm.cu")
    reader = _reader("dinov3.layer_norm_roofline")
    for k in reader.K1:
        assert re.search(r"__global__ void __launch_bounds__\([^)]*\)\s*"
                         + k + r"\(", ln), k
    up = _src("upscale_product.cu")
    assert re.search(r"template <bool kFromT1>\s*__global__ void "
                     r"__launch_bounds__\([^)]*\)\s*post_t1_mma_kernel\(",
                     up)
    assert re.search(r"return launch_mma<false>\(src, k1,", up)


# --- on the card ------------------------------------------------------------

@pytest.mark.cuda
def test_graph_replay_is_read_on_the_card():
    """A module whose forward replays one CUDA graph of kernel 10 (Hiera-L's
    stage-3 windows of 256 on the plain tile, its stage-1 windows of 64 on
    kWindow) and K1 (DINOv3-7B's [1374, 4096]), traced three times with its
    range installed: kernel 10's and K1's launches are read inside it (2
    and 1 a replay), and the wrappers on the functions see no call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from portbench import run
    from portbench.harness import tracing
    from no_time_to_train_tpu_torch.ops import attention, fused_ln
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(3)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev,
                           dtype=torch.bfloat16)

    qkv3, qkv1 = randn(1, 4096, 3 * 576), randn(1, 65536, 3 * 144)
    x, w, b = randn(1374, 4096), randn(4096), randn(4096)

    def body():
        return (attention.flash_sdpa_window_qkv(qkv3, 8, 256),
                attention.flash_sdpa_window_qkv(qkv1, 2, 64),
                fused_ln.layer_norm(x, w, b, 1e-5))

    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        eager = body()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        static = body()

    class Layer(torch.nn.Module):
        def forward(self):
            graph.replay()
            return static

    holder = SimpleNamespace(layer=Layer())
    k10, k1 = (_reader("flash_sdpa_window_qkv_roofline"),
               _reader("dinov3.layer_norm_roofline"))
    ranges = tracing.Ranges()
    ranges.install(holder, "pb.hiera", ("module", "layer"))
    for r in (k10, k1):
        for name, where in r.RANGES.items():
            if name.startswith("pb.k."):
                ranges.install(holder, name, where, r.WORK[name])
    try:
        with tracing.profiled(dev) as held:
            for _ in range(3):
                holder.layer()
    finally:
        ranges.remove()
    torch.cuda.synchronize(dev)
    for out, ref in zip(static, eager):
        assert torch.equal(out, ref)
    trace = held.trace

    def launches(select):
        return sum(1 for i, (n, _, _, ts, tid) in enumerate(trace.kernels)
                   if ts is not None and select(n, trace.grids.get(i, ()))
                   and trace._inside("pb.hiera", ts, tid))

    assert launches(kernels.window_qkv) == 6, trace.kernels
    assert launches(k1.k1) == 3
    assert launches(kernels.bnhd) == 0
    assert ranges.calls["pb.k.flash_sdpa_window_qkv"] == []
    assert ranges.calls["pb.k.dinov3_norm"] == []
    view = run.RunView(
        SimpleNamespace(config={"matching": {"compute_dtype": "bfloat16"}}),
        None, SimpleNamespace(finished=3), trace, ranges.calls, PEAK, [])
    share = view.kernel_share(
        "k10", ["pb.hiera"], kernels.window_qkv,
        lambda cfg: [common.window_call(4096, 576, 256),
                     common.window_call(65536, 144, 64)],
        seen="pb.k.flash_sdpa_window_qkv")
    print("\n".join(view.notes))
    assert 0 < share < 100
