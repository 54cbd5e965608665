"""Faults planted in the program's timed path, to show that the comparison
catches them (`portbench/tests/test_portbench_faults.py` on the CPU,
`portbench/control.py` on the card at the cells' own sizes). Each is a
context manager that patches the program while it is open.

  stale_answer   the step returns its state unchanged: every request gets
                 the outputs of the request before it;
  half_batch     half of the batch left out, the mean taken over the
                 rest: the decoder's token-to-image attention (kernel K2)
                 attends to the first half of the image tokens only;
  answer_altered an answer altered where it is produced: the first
                 output's label moves to the next class in `_match`;
  answer_dropped an answer left out where it is produced: `_match` drops
                 its first output and the others move up;
  mask_altered   the finalized masks move down by 8 rows (a finalize that
                 misplaces what it was given).

A cell on one chip has no exchange between chips to leave out.
"""
import contextlib

import numpy as np
import torch

__all__ = ["FAULTS"]


@contextlib.contextmanager
def _patched(owner, name, make):
    inner = getattr(owner, name)
    setattr(owner, name, make(inner))
    try:
        yield
    finally:
        setattr(owner, name, inner)


def stale_answer():
    from no_time_to_train_tpu_torch.models.matching import pipeline
    last = {}

    def make(inner):
        def test_async(self, tar_img):
            out = inner(self, tar_img)
            prev = last.get("out", out)
            last["out"] = out
            return prev
        return test_async
    return _patched(pipeline.NoAMGMatcher, "test_async", make)


def half_batch():
    from no_time_to_train_tpu_torch.models.sam2 import transformer

    def make(inner):
        def fused_t2i_attn(keys, pe_k, q, *rest, **kw):
            n = keys.shape[-2] // 2
            return inner(keys[..., :n, :].contiguous(),
                         pe_k[..., :n, :].contiguous(), q, *rest, **kw)
        return fused_t2i_attn
    return _patched(transformer, "fused_t2i_attn", make)


def answer_altered():
    from no_time_to_train_tpu_torch.models.matching import pipeline

    def make(inner):
        def match(self, tar_feat, lr, pred_ious):
            out = inner(self, tar_feat, lr, pred_ious)
            n_cls = self.bank.feats_ins_avg.shape[0]
            labels = out["labels"].clone()
            labels[0] = (labels[0] + 1) % n_cls
            return dict(out, labels=labels)
        return match
    return _patched(pipeline.NoAMGMatcher, "_match", make)


def answer_dropped():
    from no_time_to_train_tpu_torch.models.matching import pipeline

    def make(inner):
        def match(self, tar_feat, lr, pred_ious):
            out = inner(self, tar_feat, lr, pred_ious)
            moved = {k: torch.cat([v[1:], v[:1]]) for k, v in out.items()}
            moved["valid"] = torch.cat([out["valid"][1:],
                                        torch.zeros_like(out["valid"][:1])])
            return moved
        return match
    return _patched(pipeline.NoAMGMatcher, "_match", make)


def mask_altered():
    from no_time_to_train_tpu_torch.models.matching import pipeline

    def shift(mask):
        return np.concatenate([np.zeros_like(mask[..., :8, :]),
                               mask[..., :-8, :]], axis=-2)

    def make(inner):
        def finalize_results(out, ori_h, ori_w, exact_resize=False):
            res = inner(out, ori_h, ori_w, exact_resize)
            return dict(res, binary_masks=shift(res["binary_masks"]))
        return finalize_results
    return _patched(pipeline, "finalize_results", make)


FAULTS = {"stale_answer": stale_answer, "half_batch": half_batch,
          "answer_altered": answer_altered, "answer_dropped": answer_dropped,
          "mask_altered": mask_altered}
