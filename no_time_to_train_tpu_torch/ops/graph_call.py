"""One call site of a model replayed as a CUDA graph.

A chain of a few hundred small launches costs the host more time than the
card spends on it. `GraphSite` replays such a chain as one CUDA graph per
call on the card:

  - the key of a call is its input signature (each tensor's shape and
    dtype, the device), whether `no_fusion()` is on, and what the site adds
    (the branches its code takes that the inputs do not show);
  - the site captures when one key arrives on two consecutive calls, and
    holds at most one graph: a call with another key drops it, with its
    pool, and runs eagerly, so calls that alternate between keys stay
    eager;
  - a replay copies the inputs into the graph's static buffers, and every
    tensor it returns is a fresh copy of a static output, except the outputs
    the caller names as scratch: those are the graph's own buffers, which
    the caller consumes before the site's next call, on the same stream;
  - the static outputs stay allocated (in the graph's private memory pool)
    for as long as the graph lives, and count as allocated memory, so a
    site's outputs should be small; the pool's whole size is the growth of
    the reserved memory (`pool_bytes`);
  - the capturing call first runs the eager code once on a side stream, on
    copies of the inputs (the first use of that stream's library handles),
    drops that result, captures, and returns the capture's replay; a failed
    capture raises;
  - a graph that reads a table derived from a tensor that has been written
    since (`graph_inputs.held` with a `source`: the W8A8 levels of a
    weight) is dropped, and the call captures again.

Only calls on a CUDA device's default stream, outside autograd, take the
graph. Everything else runs the eager code unchanged: the CPU, a call that
records gradients, and calls on other streams (data-parallel replicas on
one device share their modules, and a site's buffers serve one stream).

The kernels' launch counters (`_cuda.count`) count each call's launches
once, graph or not: a replay as the launches its capture made, and the
capturing call's eager run and capture as none.

`stats` (the owning module's `graph_stats`) keeps, per (site, key),
`captures`, `replays` and `eager` calls, and of the latest capture the
seconds of the capturing call (`capture_s`) and the growth of the device's
reserved memory (`pool_bytes`). A capture runs inside the span
`nttt.capture`. The video scan (`models/sam2/video.py`) captures through
`capture` too. A graph replays the weights at the addresses it saw: a
`GraphOwner` that moves or loads its weights resets its sites.
"""
import threading
import time

import torch

from no_time_to_train_tpu_torch.ops import _cuda
from no_time_to_train_tpu_torch.ops.graph_inputs import holding
from no_time_to_train_tpu_torch.ops.upscale_product import fusion_disabled
from no_time_to_train_tpu_torch.utils.profiling import span

__all__ = ["GraphOwner", "GraphSite", "capture", "graph_stats",
           "record_capture"]


def graph_stats():
    """An empty `graph_stats` dict."""
    return {"captures": {}, "replays": {}, "eager": {}, "capture_s": {},
            "pool_bytes": {}}


def _bump(table, key):
    table[key] = table.get(key, 0) + 1


def record_capture(stats, tag, t0, pool):
    """Count a capture of (site, key) `tag` begun at perf_counter `t0`."""
    _bump(stats["captures"], tag)
    stats["capture_s"][tag] = time.perf_counter() - t0
    stats["pool_bytes"][tag] = pool


class _Captured:
    """A live graph: its key, static inputs and outputs (`one`: fn returns
    one tensor), the tables it reads (a `graph_inputs.Held`, kept alive
    beside it) and the launches its capture made."""

    def __init__(self, key, graph, static_in, static_out, held, launches):
        self.key, self.graph, self.static_in = key, graph, static_in
        self.one = not isinstance(static_out, tuple)
        self.static_out = (static_out,) if self.one else static_out
        self.held, self.launches = held, launches

    def replay(self):
        """Replay the graph; its capture's launches count once more."""
        self.graph.replay()
        _cuda.count_replay(self.launches)


def capture(fn, static_in, warm, device, key=None):
    """Run fn(*warm) once eagerly on a side stream of `device` (its first
    use: library handles, kernel builds, cached tables), drop its result,
    then capture fn(*static_in) there. Neither counts a launch. Returns (the
    _Captured graph, its pool: the growth of the reserved memory)."""
    with torch.cuda.device(device):
        cur = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(cur)
        with torch.cuda.stream(side), _cuda.recorded_launches():
            fn(*warm)
        cur.wait_stream(side)
        torch.cuda.synchronize(device)
        # the capture takes a cuBLAS workspace of its own from the graph's
        # pool, as torch's graph trees do: the side stream's eager one
        # (32 MiB on Hopper) is not kept
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        with holding() as held, _cuda.recorded_launches() as launches, \
                torch.cuda.graph(graph, stream=side,
                                 capture_error_mode="thread_local"):
            static_out = fn(*static_in)
        torch.cuda.synchronize(device)
        torch._C._cuda_clearCublasWorkspaces()
        pool = torch.cuda.memory_reserved(device) - reserved
    return _Captured(key, graph, static_in, static_out, held, launches), pool


class GraphSite:
    """One call site: `site(fn, *args, key=..., scratch=...)`."""

    def __init__(self, name, stats):
        self.name, self.stats = name, stats
        self._lock = threading.Lock()
        self._last = None        # key of the previous call on the graph path
        self._live = None        # the _Captured graph, or None

    def __reduce__(self):
        # a copied module (deepcopy, pickle) starts with no graph
        return type(self), (self.name, self.stats)

    def reset(self):
        """Drop the graph and forget the previous key."""
        with self._lock:
            self._last = self._live = None

    def _capturable(self, args):
        """Whether the call takes the graph path."""
        dev = args[0].device
        return (dev.type == "cuda" and not torch.is_grad_enabled()
                and _cuda.stream_ptr(dev) == 0)

    def __call__(self, fn, *args, key=(), scratch=()):
        """fn(*args) (tensors in, a tensor or a tuple of tensors out), or its
        graph's replay on these inputs."""
        if not self._capturable(args):
            return fn(*args)
        k = (tuple((tuple(a.shape), a.dtype) for a in args), args[0].device,
             fusion_disabled(), key)
        tag = (self.name, k)
        with self._lock:
            live = self._live
            if live is not None and live.key == k \
                    and not live.held.stale():
                _bump(self.stats["replays"], tag)
                return self._replay(live, args, scratch)
            self._live = None
            if self._last == k:
                return self._capture(fn, args, k, tag, scratch)
            self._last = k
            _bump(self.stats["eager"], tag)
        return fn(*args)

    @staticmethod
    def _replay(live, args, scratch):
        for s, a in zip(live.static_in, args):
            s.copy_(a)
        live.replay()
        outs = tuple(o if i in scratch else o.clone()
                     for i, o in enumerate(live.static_out))
        return outs[0] if live.one else outs

    def _capture(self, fn, args, k, tag, scratch):
        t0 = time.perf_counter()
        with span("nttt.capture"):
            # allocated on the caller's stream: a dropped graph's inputs go
            # back to it, and its later work runs after the last replay
            static_in = tuple(torch.empty_like(a).copy_(a) for a in args)
            self._live, pool = capture(fn, static_in, static_in,
                                       args[0].device, k)
            outs = self._replay(self._live, args, scratch)
        record_capture(self.stats, tag, t0, pool)
        return outs


class GraphOwner(torch.nn.Module):
    """A module whose graphs replay its weights: moving or loading them resets
    every GraphSite it holds (an attribute, or a dict's value) and bumps
    `graph_generation`, which the video scan's graphs compare."""

    graph_generation = 0

    def _reset_graphs(self):
        for v in vars(self).values():
            for site in v.values() if isinstance(v, dict) else (v,):
                if isinstance(site, GraphSite):
                    site.reset()
        self.graph_generation += 1

    def _apply(self, fn, recurse=True):
        self._reset_graphs()
        return super()._apply(fn, recurse)

    def _load_from_state_dict(self, *args, **kwargs):
        self._reset_graphs()
        super()._load_from_state_dict(*args, **kwargs)
