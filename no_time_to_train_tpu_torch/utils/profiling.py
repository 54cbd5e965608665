"""Tracing and profiling utilities (port of
`no_time_to_train_tpu/utils/profiling.py`).

The reference's observability is wall-clock only (synchronized per-image
timers and an nvidia-smi poller). Here:
  - `Timer`: completion-fenced per-step timing with the aggregate report of
    the reference's FPS harness (run_lightning.py:152-161);
  - `trace`: a context manager around `torch.profiler` that writes a Chrome
    trace (open it in chrome://tracing or Perfetto);
  - `device_memory_stats`: the caching allocator's counters of one CUDA
    device under the JAX package's keys. They describe this process only;
    `utils/memory_poller.py` reads the whole device.
"""
import contextlib
import os
import time

import numpy as np
import torch

__all__ = ["Timer", "trace", "device_memory_stats"]


class Timer:
    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def step(self, sync=None):
        """Time one step; `sync` is an optional callable that waits for the
        device (e.g. torch.cuda.synchronize, or lambda: out["scores"].cpu())."""
        t0 = time.time()
        yield
        if sync is not None:
            sync()
        self.times.append(time.time() - t0)

    def report(self, header="[Validation] Inference Time Benchmark:"):
        t = np.asarray(self.times)
        print(f"\n{header}")
        print(f"  Total images: {len(t)}")
        print(f"  Total time: {t.sum():.4f} s")
        print(f"  Average time per image: {t.mean():.4f} s")
        print(f"  FPS: {1.0 / t.mean():.2f}")
        return {"total": float(t.sum()), "mean": float(t.mean()),
                "fps": float(1.0 / t.mean())}


@contextlib.contextmanager
def trace(logdir="nttt_trace"):
    """Profile the block with torch.profiler (CPU, and CUDA where a device
    is there) and write `<logdir>/trace.json`. Yields the profiler."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def device_memory_stats(device=None):
    """{"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} of a CUDA device
    in this process (torch.cuda.memory_stats), or {} for another device."""
    d = torch.device(device) if device is not None else (
        torch.device("cuda") if torch.cuda.is_available() else None)
    if d is None or d.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(d)
    return {"bytes_in_use": s.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": s.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(d).total_memory}
