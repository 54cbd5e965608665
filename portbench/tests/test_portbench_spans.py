"""The readers of the program's `nttt.*` spans: a traced tiny run reports
their host times; on a program without the spans (or a trace without
device activity) they read nothing and raise nothing; `enqueue.launches`
counts the device activities whose launch lies inside an `nttt.enqueue`
span on the launching thread."""
import os
from types import SimpleNamespace

import pytest

from conftest import ROOT, run_tiny
from portbench.harness.cells import load_module

HOST = ["upload.host_ms", "dino.host_ms", "hiera.host_ms", "decode.host_ms",
        "match.host_ms", "fetch.host_ms", "finalize.host_ms"]
DEVICE = ["match.device_ms", "enqueue.launches"]


def _reader(name):
    return load_module(os.path.join(ROOT, "portbench", "metrics",
                                    name + ".py"),
                       "spans_" + name.replace(".", "_"))


def _run(ranges, kernels, finished=2):
    """What a reader sees of a traced segment of `finished` requests."""
    from portbench.harness.tracing import Trace
    from portbench.run import RunView
    trace = Trace([])
    trace.ranges, trace.kernels = ranges, kernels
    return RunView(None, None, SimpleNamespace(finished=finished), trace,
                   {}, None, [])


def test_traced_tiny_run_reports_host_spans(tiny_root, torch_threads):
    res = run_tiny(tiny_root, "tiny.single", trace=1)
    for name in HOST:
        assert res["metrics"][name]["value"] > 0, name
    assert "matcher.enqueue_ms.single" in res["metrics"]
    assert res["correct"]


@pytest.mark.parametrize("name", HOST + DEVICE)
def test_readers_without_spans_read_nothing(name):
    kernels = [("k", 10.0, 5.0, 3.0, 1)]
    assert _reader(name).read(_run({"pb.request": [(0.0, 50.0, 1)]},
                                   kernels)) is None


def test_host_reader_means_per_request():
    run = _run({"nttt.decode": [(0.0, 1000.0, 1), (1500.0, 2500.0, 1),
                                (3000.0, 5000.0, 1)]}, [])
    assert _reader("decode.host_ms").read(run) == pytest.approx(2.0)


def test_launches_inside_enqueue_on_its_thread():
    ranges = {"nttt.enqueue": [(100.0, 200.0, 1), (300.0, 400.0, 1)],
              "nttt.match": [(150.0, 190.0, 1)]}
    kernels = [("a", 210.0, 4.0, 110.0, 1),     # inside the first
               ("b", 215.0, 6.0, 160.0, 1),     # inside, and in the match
               ("Memcpy", 220.0, 1.0, 350.0, 1),  # inside the second
               ("c", 230.0, 1.0, 250.0, 1),     # between the spans
               ("d", 240.0, 1.0, 120.0, 2),     # another thread
               ("e", 250.0, 1.0, None, None)]   # no launch found
    run = _run(ranges, kernels)
    assert _reader("enqueue.launches").read(run) == 1.5
    assert _reader("match.device_ms").read(run) == pytest.approx(0.003)
