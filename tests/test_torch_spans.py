"""The port's test-step spans (`utils/profiling.span`) on the tiny matcher:
under `torch.profiler` each layer boundary of `test` and `test_batch_async`
records its `nttt.*` range, with the counts per request that the
benchmark's readers divide by, and inside the request's `nttt.enqueue` (or
after it, for the fetch and the finalize) on the same thread; with no
profiler running, a span never reaches `record_function`."""
import json

import numpy as np
import pytest
import torch

from no_time_to_train_tpu_torch.models.matching.pipeline import (
    finalize_results)
from no_time_to_train_tpu_torch.utils import profiling

from test_torch_matching import _port_matcher

INSIDE = ("nttt.upload", "nttt.dino", "nttt.hiera", "nttt.decode",
          "nttt.match")
AFTER = ("nttt.fetch", "nttt.finalize")


@pytest.fixture(scope="module")
def matcher():
    return _port_matcher()


def _spans(prof, tmp_path):
    """{name: [(start, end, tid)]} of the `nttt.*` ranges in the exported
    Chrome trace, as the benchmark's tracing reads it."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    out = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and \
                e["name"].startswith("nttt."):
            out.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"], e["tid"]))
    return {k: sorted(v) for k, v in out.items()}


@pytest.mark.parametrize("batch", [0, 2])
def test_step_spans_nest_in_their_request(matcher, tmp_path, batch):
    """One request: `test` on one image, or `test_batch_async` on two and
    one `fetch_test`; then `finalize_results` per image."""
    imgs = np.random.default_rng(5).random((max(batch, 1), 128, 128, 3),
                                           np.float32)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        if batch:
            out = matcher.fetch_test(matcher.test_batch_async(imgs))
            per = [{k: v[b] for k, v in out.items()} for b in range(batch)]
        else:
            per = [matcher.test(imgs[0])]
        for o in per:
            finalize_results(o, 96, 80)
    spans = _spans(prof, tmp_path)
    n_img = max(batch, 1)
    m = matcher.matching
    chunks = m.points_per_side ** 2 // m.testing_point_bs
    assert {k: len(v) for k, v in spans.items()} == {
        "nttt.enqueue": 1, "nttt.upload": 1, "nttt.dino": 1,
        "nttt.hiera": 1, "nttt.decode": chunks, "nttt.match": n_img,
        "nttt.fetch": 1, "nttt.finalize": n_img}
    (s0, e0, tid), = spans["nttt.enqueue"]
    for name in INSIDE:
        for s, e, t in spans[name]:
            assert t == tid and s0 <= s <= e <= e0, name
    for name in AFTER:
        for s, e, t in spans[name]:
            assert t == tid and s >= e0, name
    # spans of one name do not nest on one thread
    for name, v in spans.items():
        assert all(a[1] <= b[0] for a, b in zip(v, v[1:])), name


def test_span_without_profiler_never_records(matcher, monkeypatch):
    """With no profiler running the step takes the shared no-op: a span
    that reached `record_function` would raise here."""
    def boom(*a, **k):
        raise AssertionError("record_function called with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", boom)
    assert profiling.span("nttt.a") is profiling.span("nttt.b")
    img = np.random.default_rng(6).random((128, 128, 3), np.float32)
    out = matcher.fetch_test(matcher.test_batch_async(img[None]))
    finalize_results({k: v[0] for k, v in out.items()}, 96, 80)
    assert set(matcher.test(img)) == set(out)
