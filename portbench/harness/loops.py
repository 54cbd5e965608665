"""The loop that drives the program, chosen by a traffic file's `loop`
key: `closed`, one user in a closed loop. Each request hands a host image
(the demo's 1024^2 query) to `NoAMGMatcher.test` and resizes its result
to the image's original size with `finalize_results`; the next request
goes when that returns. A request's latency runs from the call to the
return.

The loop keeps host spans (perf_counter seconds) of its steps and, for
each request it finishes, a compact copy of what the program returned,
the latest finished request of each distinct input only.
"""
import contextlib
import time

import numpy as np

__all__ = ["Record", "closed_loop", "compact", "timed_method"]


class Record:
    """What one run of a loop measured."""

    def __init__(self):
        self.latencies = []      # seconds per finished request
        self.spans = {}          # name -> seconds of each occurrence
        self.kept = {}           # input index -> compact outputs
        self.n_valid = []        # valid outputs per finished request
        self.inputs = []         # input index of each finished request
        self.t0 = self.t1 = None

    @property
    def seconds(self):
        return self.t1 - self.t0

    @property
    def finished(self):
        return len(self.n_valid)

    def span(self, name, seconds):
        self.spans.setdefault(name, []).append(seconds)


def compact(out):
    """fetch_test's dict cut to its valid prefix, copied."""
    n = int(np.asarray(out["valid"]).sum())
    return dict(n=n, lr=np.array(out["lr_logits"][:n]),
                scores=np.array(out["scores"][:n]),
                labels=np.array(out["labels"][:n]),
                pred_ious=np.array(out["pred_ious"][:n]))


@contextlib.contextmanager
def timed_method(obj, name, record, span):
    """Time every call of `obj.name` into `record`'s span `span`, by an
    instance attribute that shadows the method for the block's duration."""
    inner = getattr(obj, name)

    def wrapped(*a, **k):
        t = time.perf_counter()
        try:
            return inner(*a, **k)
        finally:
            record.span(span, time.perf_counter() - t)

    setattr(obj, name, wrapped)
    try:
        yield
    finally:
        delattr(obj, name)


def closed_loop(matcher, images, sizes, seconds, count=None, record=None,
                around=None, start=0, before=None):
    """Requests cycle over the pool `images` (host arrays) with original
    sizes `sizes`, from pool index `start`, for `seconds` (or `count`
    requests). `around(i)` optionally wraps each request in a context;
    `before(k)` is told the input of each request first. Returns the
    Record."""
    from no_time_to_train_tpu_torch.models.matching.pipeline import (
        finalize_results)
    rec = record or Record()
    n = len(images)
    rec.t0 = time.perf_counter()
    i = 0
    while True:
        k = (start + i) % n
        h, w = sizes[k]
        if before is not None:
            before(k)
        ctx = around(i) if around is not None else contextlib.nullcontext()
        with ctx:
            t0 = time.perf_counter()
            out = matcher.test(images[k])
            tm = time.perf_counter()
            fin = finalize_results(out, h, w)
            t1 = time.perf_counter()
        rec.latencies.append(t1 - t0)
        rec.span("test", tm - t0)
        rec.span("finalize", t1 - tm)
        rec.n_valid.append(int(out["valid"].sum()))
        rec.inputs.append(k)
        rec.kept[k] = dict(compact(out), masks=fin["binary_masks"],
                           boxes=fin["bboxes"], size=(h, w))
        i += 1
        if (count is not None and i >= count) or (
                count is None and t1 - rec.t0 >= seconds):
            rec.t1 = t1
            return rec
