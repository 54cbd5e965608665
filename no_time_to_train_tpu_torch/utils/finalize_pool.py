"""A process pool for the per-image host finalize (the native one-pass
upsample, RLE and box of `pipeline.finalize_records`), for data-parallel
test loops whose device rate outruns one host core (port of
`no_time_to_train_tpu/utils/finalize_pool.py`). RLE string building is
Python and C bytes work, so threads would serialize on the interpreter lock
between native calls.

Every worker starts with the GPU hidden and imports only this module,
`utils/native.py` and numpy, so no worker can create a CUDA context:
  - the pool is a spawn-context `multiprocessing.Pool`, which starts all its
    workers at construction (a `ProcessPoolExecutor` would start later ones
    on demand, outside any scrubbed environment);
  - they start with CUDA_VISIBLE_DEVICES="" in the environment, and the
    initializer sets it again before any task;
  - the spawn start method re-imports the parent's main module in each
    child (the CLI's imports torch), so the workers start while a bare main
    module stands in for it.
Each worker reports its pid, CUDA_VISIBLE_DEVICES and whether torch is
loaded at start (`FinalizePool.workers`).
"""
import multiprocessing
import os
import sys
import types
from concurrent.futures import Future

import numpy as np

__all__ = ["FinalizePool"]

# seconds a worker may take to start (a spawned interpreter importing numpy)
_START_TIMEOUT_S = 120.0


def _finalize_row(logits_f16, ori_h, ori_w):
    """One image's winners -> (segs, boxes), in a worker."""
    from no_time_to_train_tpu_torch.utils import native
    x = np.asarray(logits_f16, np.float32)
    n = x.shape[0]
    segs, boxes = [], np.zeros((n, 4), np.float32)
    for i in range(n):
        counts, box, _ = native.finalize_mask(x[i], ori_h, ori_w)
        segs.append({"size": [int(ori_h), int(ori_w)], "counts": counts})
        boxes[i] = box
    return segs, boxes


def _start_worker(reports):
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    reports.put({"pid": os.getpid(),
                 "CUDA_VISIBLE_DEVICES": os.environ["CUDA_VISIBLE_DEVICES"],
                 "torch_loaded": "torch" in sys.modules})


class FinalizePool:
    """`procs` worker processes over `_finalize_row`. Construct it only
    where the native finalize exists (`native.has_finalize()`)."""

    def __init__(self, procs):
        ctx = multiprocessing.get_context("spawn")
        reports = ctx.Queue()
        saved_env = os.environ.get("CUDA_VISIBLE_DEVICES")
        saved_main = sys.modules["__main__"]
        os.environ["CUDA_VISIBLE_DEVICES"] = ""
        sys.modules["__main__"] = types.ModuleType("__main__")
        try:
            self._pool = ctx.Pool(procs, initializer=_start_worker,
                                  initargs=(reports,))
        finally:
            sys.modules["__main__"] = saved_main
            if saved_env is None:
                os.environ.pop("CUDA_VISIBLE_DEVICES")
            else:
                os.environ["CUDA_VISIBLE_DEVICES"] = saved_env
        self.workers = [reports.get(timeout=_START_TIMEOUT_S)
                        for _ in range(procs)]

    def submit_row(self, logits_f16, ori_h, ori_w):
        """-> Future[(segs, boxes)]. Pass the valid prefix only, in float16:
        the pipe is the pool's overhead."""
        fut = Future()
        self._pool.apply_async(_finalize_row, (logits_f16, ori_h, ori_w),
                               callback=fut.set_result,
                               error_callback=fut.set_exception)
        return fut

    def shutdown(self):
        self._pool.close()
        self._pool.join()
