"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout, on a machine with the NVIDIA GPUs the cell
asks for. The cell (`BENCHMARK.json`'s `workloads`) names a configuration
(`portbench/configs/<c>.json`) and a traffic mix
(`portbench/traffic/<t>.json`). Set-up makes the weights and the inputs
from the seed, builds `no_time_to_train_tpu_torch`'s `NoAMGMatcher`, fills
and post-processes its memory bank, and warms the traffic's loop; the
measured window then drives the loop for `--seconds`. With `--trace 1` a
segment of the same loop runs after the window under `torch.profiler`,
with ranges around the port's layers, and the per-layer metrics are read
from the window's host spans and the segment's trace. Then the program's
state is freed and a sample of the window's requests is checked against
the plain float32 reference (`portbench/harness/check.py`).

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` a `breakdown`,
and last `check`, each compared number with its limit (also the last
lines of standard error). Without enough CUDA devices, or if JAX or the
JAX package is loaded once the window has closed, it exits non-zero and
prints no result.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "no_time_to_train_tpu")


class NoResult(Exception):
    """The run ends without a result line (exit code `code`)."""

    def __init__(self, msg, code):
        super().__init__(msg)
        self.code = code


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cache_dirs(root):
    """Every build and kernel cache inside the checkout, at fixed paths."""
    build = os.path.join(root, "build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(build, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(build, "triton")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(build, "cuda_cache")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules():
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def card_line(query="name,power.limit"):
    """`nvidia-smi`'s reading of `query` on the first card, or ''."""
    try:
        res = subprocess.run(
            ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.SubprocessError):
        return ""
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else ""


CLOCKS = "clocks.sm,clocks.mem,power.draw,temperature.gpu"


def host_probe(device, sync, repeats=5):
    """The host's speed as this process sees it, outside the program:
    (ms of a fixed pure-Python loop, us a launch of 2000 one-element
    additions on `device` until the last returns), the least of
    `repeats` tries each."""
    import torch
    loop, launch = [], []
    x = torch.zeros(1, device=device)
    for _ in range(repeats):
        t = time.perf_counter()
        sum(i * i for i in range(100000))
        loop.append(time.perf_counter() - t)
        sync()
        t = time.perf_counter()
        for _ in range(2000):
            x.add_(1.0)
        launch.append(time.perf_counter() - t)
        sync()
    return 1e3 * min(loop), 1e6 * min(launch) / 2000


class RunView:
    """What a per-layer metric's reader sees of one run."""

    def __init__(self, cell, record, segment, trace, calls, peak, probes):
        self.cell, self.record, self.segment = cell, record, segment
        self.trace, self.calls, self.peak = trace, calls, peak
        self.probes = probes
        self.notes = []

    def span_ms(self, name):
        v = self.record.spans.get(name)
        return 1e3 * statistics.fmean(v) if v else None

    def range_ms(self, name):
        if self.trace is None or not self.segment.finished:
            return None
        us = self.trace.device_us(name)
        return us * 1e-3 / self.segment.finished if us > 0 else None

    def _least(self, calls):
        """(least seconds, operations' seconds, bytes' seconds) of
        `calls`, each (operations, bytes): a call's least time is the
        larger of its operations over the compute dtype's peak and its
        bytes over the memory bandwidth."""
        flops = self.peak[self.cell.config["matching"]["compute_dtype"]]
        bw = self.peak["bytes_per_s"]
        return (sum(max(o / flops, b / bw) for o, b in calls),
                sum(o for o, _ in calls) / flops,
                sum(b for _, b in calls) / bw)

    def _share(self, name, calls, measured):
        least, t_ops, t_bytes = self._least(calls)
        self.notes.append(
            f"{name}: {len(calls)} calls, least {least * 1e3:.4f} ms (bound "
            f"by {'operations' if t_ops >= t_bytes else 'bytes'}: operations "
            f"{t_ops * 1e3:.4f} ms, bytes {t_bytes * 1e3:.4f} ms), measured "
            f"{measured * 1e3:.4f} ms")
        return 100.0 * least / measured

    def roofline(self, name, kernels):
        """The share of the calls that the wrapper of range `name` counted,
        over the device time of the kernels launched inside those calls
        (those that `kernels(name, grid)` takes; None: every kernel)."""
        calls = self.calls.get(name)
        if self.trace is None or not calls or self.peak is None:
            return None
        measured = self.trace.device_us(name, kernels) * 1e-6
        if measured <= 0:
            return None
        return self._share(name, calls, measured)

    def kernel_share(self, name, ranges, kernels, calls_per_request, seen):
        """A kernel's share of its roofline: the least time of one
        request's calls from the configuration (`calls_per_request(config)`,
        each (operations, bytes)) times the requests of the traced segment,
        over the device time of the launches that `kernels(name, grid)`
        takes among those inside any of the ranges `ranges`. The notes set
        the calls that the wrapper of range `seen` counted (eager code)
        beside the configuration's, with the share that they give over the
        same kernels inside those calls; they never decide the reading."""
        if self.trace is None or self.peak is None \
                or not self.segment.finished:
            return None
        measured = self.trace.device_us(ranges, kernels) * 1e-6
        if measured <= 0:
            return None
        per_request = list(calls_per_request(self.cell.config))
        n = self.segment.finished
        share = self._share(name, per_request * n, measured)
        calls = self.calls.get(seen, [])
        by_calls = self.trace.device_us(seen, kernels) * 1e-6
        note = (f"{name}: {len(calls)} calls seen against the "
                f"configuration's {len(per_request)} x {n} requests: "
                + ("equal" if calls == per_request * n else "unequal"))
        if calls and by_calls > 0:
            old = 100.0 * self._least(calls)[0] / by_calls
            note += (f"; from the calls seen {old:.4f} %, from the "
                     f"configuration {share:.4f} % "
                     f"({100.0 * (share / old - 1.0):+.3f} %)")
        self.notes.append(note)
        return share

    def idle_pct(self):
        if self.trace is None:
            return None
        win = self.trace.window("pb.request")
        if win is None or win[1] <= win[0]:
            return None
        busy, _ = self.trace.busy(*win)
        return 100.0 * (1.0 - busy / (win[1] - win[0]))

    def mfu(self):
        if self.peak is None or not self.record.finished:
            return None
        cfg = self.cell.config
        flops = self.cell.counts.image_flops(cfg)
        rate = flops * self.record.finished / self.record.seconds
        return 100.0 * rate / self.peak[cfg["matching"]["compute_dtype"]]


def _fill_bank(matcher, cfg, seed, device):
    from portbench.harness import inputs
    imgs, masks, cats = inputs.reference_set(cfg["bank"], seed, device)
    for s in range(0, len(cats), 8):
        matcher.fill_memory(imgs[s:s + 8], masks[s:s + 8], cats[s:s + 8])
    del imgs, masks
    matcher.postprocess_memory(seed=inputs.sub_seed(seed, 8))


class Traffic:
    """The cell's closed loop, its pool of inputs and how the reference
    gets them."""

    def __init__(self, cell, matcher, seed, device):
        from portbench.harness import inputs
        if cell.traffic["loop"] != "closed":
            raise ValueError(f"traffic loop {cell.traffic['loop']!r}")
        self.cell, self.seed, self.device = cell, seed, device
        cfg, tr = cell.config, cell.traffic
        size = cfg["topology"]["hiera"]["image_size"]
        imgs, self.sizes = inputs.targets(tr, cfg["bank"]["classes"], size,
                                          seed, device)
        self.images = [im.cpu().numpy() for im in imgs]
        del imgs
        self.matcher = matcher

    @property
    def n_inputs(self):
        return len(self.images)

    def run(self, seconds=None, count=None, record=None, around=None,
            before=None):
        from portbench.harness import loops
        return loops.closed_loop(self.matcher, self.images, self.sizes,
                                 seconds, count=count, record=record,
                                 around=around, before=before)

    def release(self):
        """Drop the program's side; keep what the reference reads."""
        self.matcher = None

    def reference_image(self, key):
        """The input `key` as the reference reads it: [S, S, 3] float32 in
        [0, 1] on the device, drawn again from the seed."""
        if not hasattr(self, "_ref_imgs"):
            from portbench.harness import inputs
            size = self.cell.config["topology"]["hiera"]["image_size"]
            self._ref_imgs, _ = inputs.targets(
                self.cell.traffic, self.cell.config["bank"]["classes"],
                size, self.seed, self.device)
        return self._ref_imgs[key]


def run_check(cell, seed, record, traffic, sam2_sd, dino_sd, device,
              planned, captured):
    """The reference on the sampled requests. Returns (numbers, per-key
    numbers, seconds). Logs the prototypes' time a reference image, the
    step's time a checked request and the check's memory peaks."""
    import resource
    import torch
    from portbench.harness import check, inputs
    from portbench.reference import matcher as ref
    t0 = time.perf_counter()
    cfg = cell.config
    dino = cfg["topology"]["dino"]
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    keys = check.sample_keys(record.kept, planned)
    per_key = {}
    with ref.float32_exact(), torch.no_grad():
        used = ("image_encoder.", "sam_prompt_encoder.", "sam_mask_decoder.")
        sd2 = {k: v.to(device) for k, v in sam2_sd.items()
               if k.startswith(used)}
        sdd = {k: v.to(device) for k, v in dino_sd.items()}
        imgs, masks, cats = inputs.reference_set(cfg["bank"], seed, device)
        t1 = time.perf_counter()
        protos = ref.prototypes(sdd, dino, imgs, masks, cats,
                                cfg["bank"]["classes"])
        n_refs = len(cats)
        del imgs, masks
        if cuda:
            torch.cuda.synchronize(device)
        t2 = time.perf_counter()
        step = ref.Step(cfg, sd2, sdd, protos, device)
        for k in keys:
            out = step(traffic.reference_image(k))
            per_key[k] = check.compare(record.kept[k], out, cfg,
                                       captured.get(k))
            del out
    t3 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    _log(f"check: weights and references {t1 - t0:.2f} s; prototypes of "
         f"{n_refs} references in blocks of {ref.ref_block(dino)} "
         f"{t2 - t1:.2f} s "
         f"({(t2 - t1) / n_refs:.4f} s a reference); {len(keys)} requests "
         f"{t3 - t2:.2f} s ({(t3 - t2) / max(1, len(keys)):.3f} s a "
         f"request); device peak {peak} bytes; host peak {rss} bytes")
    numbers = {n: max(v[n] for v in per_key.values()) for n in check.NUMBERS}
    return numbers, per_key, time.perf_counter() - t0


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


def _setup(cell, seed, device, overrides, sync):
    """Weights, the matcher, its bank and the traffic, warmed up. Returns
    (weights, matcher, traffic, set-up seconds)."""
    from portbench.harness import inputs
    from portbench.harness.program import build_matcher, make_weights
    marks = [("imports and CUDA", time.perf_counter())]
    sam2_sd, dino_sd = make_weights(cell.config, inputs.sub_seed(seed, 0),
                                    device)
    sync()
    marks.append(("weights drawn", time.perf_counter()))
    matcher = build_matcher(cell.config, sam2_sd, dino_sd, device, overrides)
    sync()
    marks.append(("matcher built", time.perf_counter()))
    _fill_bank(matcher, cell.config, seed, device)
    sync()
    marks.append(("bank filled", time.perf_counter()))
    traffic = Traffic(cell, matcher, seed, device)
    marks.append(("traffic made", time.perf_counter()))
    traffic.run(count=cell.traffic["warmup"])
    sync()
    marks.append(("warm-up", time.perf_counter()))
    parts, prev = [], T_START
    for what, t in marks:
        parts.append(f"{what} {t - prev:.2f}")
        prev = t
    _log("set-up seconds: " + ", ".join(parts))
    return (sam2_sd, dino_sd), matcher, traffic, prev - T_START


def _traced_segment(cell, matcher, traffic, device):
    """`trace_requests` more requests under the profiler, with the ranges
    that the cell's per-layer metrics declare. Returns (Record, Trace,
    the ranges' per-call counts)."""
    from torch.profiler import record_function
    from portbench.harness import tracing
    from portbench.harness.loops import Record
    ranges = tracing.Ranges()
    for m in cell.per_layer:
        reader = cell.readers[m["name"]]
        for rname, where in getattr(reader, "RANGES", {}).items():
            if rname not in ranges.calls:
                ranges.install(matcher, rname, where,
                               getattr(reader, "WORK", {}).get(rname))
    segment = Record()
    try:
        with tracing.profiled(device) as held:
            traffic.run(count=cell.traffic["trace_requests"], record=segment,
                        around=lambda i: record_function("pb.request"))
    finally:
        ranges.remove()
    return segment, held.trace, ranges.calls


def _end_to_end(cell, record, peak, setup_s):
    import numpy as np
    lat = np.asarray(record.latencies) * 1e3
    values = {"peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
    if len(lat):
        values["image_ms_p50"] = float(np.percentile(lat, 50))
    return {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
            for m in cell.end_to_end if m["name"] in values}


def _log_window(record, setup_s, peak, card):
    import numpy as np
    if record.latencies:
        q = np.percentile(np.asarray(record.latencies) * 1e3,
                          [0, 10, 25, 50, 75, 90, 95, 99, 100])
        _log("latency ms at 0/10/25/50/75/90/95/99/100 %: "
             + " ".join(f"{v:.2f}" for v in q))
        by = {}
        for k, t, nv in zip(record.inputs, record.latencies, record.n_valid):
            by.setdefault(k, (nv, []))[1].append(t * 1e3)
        _log("by input (valid outputs: median ms): " + ", ".join(
            f"{k} ({nv}: {statistics.median(ts):.1f})"
            for k, (nv, ts) in sorted(by.items())))
    if record.spans:
        _log("host spans, mean ms: " + ", ".join(
            f"{k} {1e3 * statistics.fmean(v):.2f} (n {len(v)})"
            for k, v in sorted(record.spans.items())))
    n_valid = np.asarray(record.n_valid)
    _log(f"window: {record.finished} requests in {record.seconds:.3f} s; "
         f"valid outputs per request: mean {n_valid.mean():.3f}, max "
         f"{n_valid.max()}, histogram {np.bincount(n_valid).tolist()}; "
         f"setup {setup_s:.3f} s; peak {peak} bytes; {card}")


def main(argv=None, root=ROOT, bench=BENCH, device=None, overrides=None):
    """One run; returns the result dict (also printed). `device` given
    (the CPU tests) skips the look for CUDA devices; `overrides` replace
    matching options of the configuration (the control's
    `encoder_quant`)."""
    args = parse(argv)
    cache_dirs(root)
    import torch
    from portbench.harness import check
    from portbench.harness.cells import Cell
    from portbench.harness.loops import Record, timed_method
    from portbench.harness.peaks import peaks

    cell = Cell(args.workload, root=root, bench=bench)
    if device is None:
        if not torch.cuda.is_available():
            raise NoResult("no CUDA device: torch.cuda.is_available() is "
                           "false", 2)
        if torch.cuda.device_count() < cell.chips:
            raise NoResult(f"the cell needs {cell.chips} CUDA devices, "
                           f"{torch.cuda.device_count()} present", 2)
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    seed = args.seed
    limits = check.load_limits(bench, cell.config["name"])

    weights, matcher, traffic, setup_s = _setup(cell, seed, device,
                                                overrides, sync)
    clocks_before = card_line(CLOCKS) if cuda else ""
    probes = [host_probe(device, sync)]
    if cuda:
        _log(f"set-up device peak {torch.cuda.max_memory_allocated(device)} "
             "bytes")
        torch.cuda.reset_peak_memory_stats(device)
    record = Record()
    planned = check.planned_keys(traffic.n_inputs,
                                 cell.traffic["check_requests"], seed)
    capture = check.Capture(matcher, planned)

    def before(k):
        capture.start(k)

    spans = (timed_method(matcher, "test_async", record, "enqueue")
             if args.trace else contextlib.nullcontext())
    with spans:
        traffic.run(seconds=args.seconds, record=record, before=before)
    sync()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    capture.close()
    probes.append(host_probe(device, sync))
    _log("host probe before / after the window (python loop ms, launch "
         "us): " + " / ".join(f"{a:.3f} {b:.3f}" for a, b in probes))
    if cuda:
        _log(f"card before / after the window (sm MHz, mem MHz, W, C): "
             f"{clocks_before} / {card_line(CLOCKS)}")
    trace = None
    if args.trace:
        segment, trace, calls = _traced_segment(cell, matcher, traffic,
                                                device)
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    card = card_line() if cuda else "cpu"
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": cell.chips, "memory_peak_bytes": int(peak),
                   "power_limit": card}
    breakdown = None
    if args.trace:
        view = RunView(cell, record, segment, trace, calls, peaks(name),
                       probes)
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]].read(view)
            if v is not None:
                metrics[m["name"]] = {"value": float(v),
                                      "unit": m["unit"]}
        for note in view.notes:
            _log(note, "on", card)
        win = trace.window("pb.request")
        busy, gaps = trace.busy(*win)
        device_info["busy_s"] = busy * 1e-6
        device_info["window_s"] = (win[1] - win[0]) * 1e-6
        main_tid = trace.ranges["pb.request"][0][2]
        breakdown = {"device_ops": trace.top_ops(*win),
                     "idle_gaps": trace.gap_owners(gaps, main_tid)}
    else:
        metrics = _end_to_end(cell, record, peak, setup_s)
    _log_window(record, setup_s, peak, card)

    # free the program, then the reference on the sampled requests
    traffic.release()
    del matcher
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    captured = capture.complete()
    numbers, per_key, ref_s = run_check(cell, seed, record, traffic,
                                        *weights, device, planned,
                                        captured)
    compared = [n for n in check.NUMBERS if limits[n] is not None]
    failed = sum(any(v[n] > limits[n] for n in compared)
                 for v in per_key.values())
    if not captured:
        # the timed path ran without the hooks firing: nothing to compare
        # the encoders' and the decode's numbers on, so the check cannot
        # pass
        _log("check: nothing captured from the encoders and the decode for "
             f"the planned inputs {planned}")
        failed = max(failed, 1)
    _log(f"check: {len(per_key)} sampled requests "
         f"{sorted(per_key)} in {ref_s:.2f} s")
    for k, v in sorted(per_key.items()):
        _log(f"  request input {k}: " + ", ".join(
            f"{n} {v[n]:.6g}" for n in check.NUMBERS)
            + (f"; outputs in one list only (side, prompt, label, margin), "
               f"the clearest: "
               f"{sorted(v['unmatched'], key=lambda r: -r[3])[:4]}"
               if v["unmatched"] else ""))
    for n in check.NUMBERS:
        _log(f"{n} {numbers[n]!r} limit {limits[n]!r}")
    result = {"correct": failed == 0, "attempted": record.finished,
              "failed": int(failed), "metrics": metrics,
              "device": device_info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["check"] = {n: {"value": numbers[n], "limit": limits[n]}
                       for n in check.NUMBERS}
    bad = forbidden_modules()
    if bad:
        raise NoResult("loaded in this process once the window closed: "
                       + ", ".join(bad), 3)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    try:
        main()
    except NoResult as e:
        print(f"portbench: {e}", file=sys.stderr)
        sys.exit(e.code)
