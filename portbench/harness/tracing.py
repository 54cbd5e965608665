"""Device activity of a traced segment, attributed to the port's layers.

Ranges: each per-layer metric file may declare `RANGES`, a dict from a
range name to where the harness opens it around the program's calls
(nothing in the program changes):
  ("module", "<attribute path from the matcher>"): forward pre- and
      post-hooks on that module instance;
  ("method", "<attribute path>"): a wrapper set on the instance's method;
  ("function", "<module>", "<name>"): a wrapper on a module-level function
      where its caller looks it up.
A wrapper may also be handed the metric's `work(args, kwargs)`, which
returns (operations, bytes) of one call from its operands' shapes; the
calls' counts are kept under the range's name.

A kernel belongs to every range whose host interval encloses the launch
(the CUDA runtime or driver call with the kernel's correlation id) on the
launching thread. The kernels of a CUDA graph replay carry the correlation
id of their `cudaGraphLaunch`, so they belong to the ranges around the
replay. A kernel is told apart by its demangled name with its template
arguments (`template_args`) and by its launch grid. The traced segment
runs under `torch.profiler`, opened with spin kernels first because the
profiler can lose the first kernels after it starts; its Chrome trace is
written to $TMPDIR, read and deleted.
"""
import bisect
import contextlib
import importlib
import json
import os
import tempfile

import numpy as np
import torch

__all__ = ["Ranges", "Trace", "profiled", "template_args"]

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _resolve(root, path):
    obj = root
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


class Ranges:
    """Opens `record_function` ranges around the program's calls while
    installed; `calls[name]` lists each call's (operations, bytes) where a
    work function was given."""

    def __init__(self):
        self._undo = []
        self.calls = {}

    def install(self, matcher, name, where, work=None):
        from torch.profiler import record_function
        kind = where[0]
        calls = self.calls.setdefault(name, [])
        if kind == "module":
            mod = _resolve(matcher, where[1])
            stack = []

            def pre(_m, args):
                r = record_function(name)
                r.__enter__()
                stack.append(r)

            def post(_m, args, out):
                stack.pop().__exit__(None, None, None)

            hooks = [mod.register_forward_pre_hook(pre),
                     mod.register_forward_hook(post)]
            self._undo.append(lambda: [h.remove() for h in hooks])
            return
        if kind == "method":
            owner_path, attr = where[1].rsplit(".", 1)
            owner = _resolve(matcher, owner_path)
        elif kind == "function":
            owner, attr = importlib.import_module(where[1]), where[2]
        else:
            raise ValueError(f"range kind {kind!r}")
        inner = getattr(owner, attr)

        def wrapped(*args, **kwargs):
            if work is not None:
                calls.append(work(args, kwargs))
            with record_function(name):
                return inner(*args, **kwargs)

        setattr(owner, attr, wrapped)
        if kind == "method":
            self._undo.append(lambda: delattr(owner, attr))
        else:
            self._undo.append(lambda: setattr(owner, attr, inner))

    def remove(self):
        while self._undo:
            self._undo.pop()()


def template_args(name):
    """(qualified name, top-level template arguments) of a kernel's
    demangled name: `void attn_mma::attn_kernel<80, false, 2, 2, 2>(...)`
    gives ("attn_mma::attn_kernel", ("80", "false", "2", "2", "2")); a
    kernel that is no template gives its name and ()."""
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anonymous}")
    lt, paren = name.find("<"), name.find("(")
    if lt < 0 or 0 <= paren < lt:
        return (name if paren < 0 else name[:paren]).strip(), ()
    args, depth, start = [], 0, lt + 1
    for i in range(lt, len(name)):
        c = name[i]
        if c in "<(":
            depth += 1
        elif c in ">)":
            depth -= 1
            if depth == 0:
                args.append(name[start:i].strip())
                break
        elif c == "," and depth == 1:
            args.append(name[start:i].strip())
            start = i + 1
    return name[:lt].strip(), tuple(args)


def _spin(device):
    x = torch.ones(1 << 20, device=device)
    for _ in range(64):
        x = x * 1.0001
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def profiled(device):
    """Yields a holder whose `trace` is set to the parsed Trace once the
    block ends."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Held", (), {"trace": None})()
    cuda = device.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        _spin(device)
        yield holder
        if cuda:
            torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json", prefix="portbench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            raw = json.load(f)
    finally:
        os.remove(path)
    holder.trace = Trace(raw)


class Trace:
    """The parsed events of one traced segment. Times in microseconds on
    the profiler's clock."""

    def __init__(self, raw):
        events = raw["traceEvents"] if isinstance(raw, dict) else raw
        launches, gpu, ann, cpu = {}, [], {}, []
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in GPU_CATS:
                gpu.append(e)
            elif cat in LAUNCH_CATS:
                corr = e.get("args", {}).get("correlation")
                if corr is not None:
                    launches[corr] = (e["ts"], e["tid"])
            elif cat == "user_annotation":
                ann.setdefault(e["name"], []).append(
                    (e["ts"], e["ts"] + e["dur"], e["tid"]))
            elif cat == "cpu_op":
                cpu.append((e["ts"], e["ts"] + e["dur"], e["name"], e["tid"]))
        rows = []
        for e in gpu:
            args = e.get("args", {})
            ts, tid = launches.get(args.get("correlation"), (None, None))
            rows.append(((e["name"], e["ts"], e["dur"], ts, tid),
                         tuple(args.get("grid", ()))))
        rows.sort(key=lambda r: r[0][1])
        # (name, start, dur, launch ts, launch tid), and by index the launch
        # grid (x, y, z)
        self.kernels = [k for k, _ in rows]
        self.grids = {i: g for i, (_, g) in enumerate(rows)}
        self.ranges = {k: sorted(v) for k, v in ann.items()}
        self.cpu = cpu
        self._by_tid = {}

    def window(self, name):
        """(start, end) from the first range `name` to the end of the
        last."""
        r = self.ranges.get(name)
        if not r:
            return None
        return r[0][0], max(e for _, e, _ in r)

    def _inside(self, name, ts, tid):
        """Whether `ts` lies in a range `name` on thread `tid` (ranges of
        one name on one thread do not nest)."""
        key = (name, tid)
        if key not in self._by_tid:
            r = [(s, e) for s, e, t in self.ranges.get(name, ()) if t == tid]
            self._by_tid[key] = ([s for s, _ in r], [e for _, e in r])
        starts, ends = self._by_tid[key]
        i = bisect.bisect_right(starts, ts) - 1
        return i >= 0 and ends[i] >= ts

    def device_us(self, names, select=None):
        """Summed device time of the kernels launched inside the range
        `names` (a name, or a list of names: inside any of them), where
        given only those that `select(name, grid)` takes, with the launch
        grid (x, y, z), () where the trace gives none."""
        if isinstance(names, str):
            names = [names]
        total = 0.0
        for i, (kname, _, dur, ts, tid) in enumerate(self.kernels):
            if ts is None:
                continue
            if select is not None and not select(kname,
                                                 self.grids.get(i, ())):
                continue
            if any(self._inside(n, ts, tid) for n in names):
                total += dur
        return total

    def busy(self, start, end):
        """Union of device activity intervals clipped to [start, end], and
        the idle gaps between them."""
        busy, gaps, cur_s, cur_e = 0.0, [], None, None
        last = start
        for _, s, d, _, _ in self.kernels:
            s, e = max(s, start), min(s + d, end)
            if e <= s:
                continue
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                if s > last:
                    gaps.append((last, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
            last = cur_e
        if cur_e is not None:
            busy += cur_e - cur_s
        if end > last:
            gaps.append((last, end))
        return busy, gaps

    def top_ops(self, start, end, n=10):
        tot = {}
        for name, s, d, _, _ in self.kernels:
            if s >= start and s + d <= end:
                tot[name] = tot.get(name, 0.0) + d
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v * 1e-6] for k, v in top]

    def gap_owners(self, gaps, main_tid, n=10, longest=400):
        """The longest idle gaps grouped by the innermost host range or
        operator open on the main thread at each gap's middle."""
        if not gaps:
            return []
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:longest]
        spans = [(s, e, "range " + k) for k, v in self.ranges.items()
                 for s, e, t in v if t == main_tid]
        spans += [(s, e, k) for s, e, k, t in self.cpu if t == main_tid]
        if not spans:
            return []
        starts = np.array([s for s, _, _ in spans])
        ends = np.array([e for _, e, _ in spans])
        tot = {}
        for gs, ge in gaps:
            mid = 0.5 * (gs + ge)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = (spans[hit[np.argmax(starts[hit])]][2] if len(hit)
                     else "host outside any traced call")
            tot[label] = tot.get(label, 0.0) + (ge - gs)
        top = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:160], v * 1e-6] for k, v in top]
