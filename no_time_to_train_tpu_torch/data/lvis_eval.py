"""LVIS-style evaluation on top of the port's COCOeval core (port of
`no_time_to_train_tpu/data/lvis_eval.py`).

    python -m no_time_to_train_tpu_torch.data.lvis_eval --gt lvis_val.json \
        --results export.json [--iou-type segm]

The reference depends on the external `lvis` package (pyproject.toml); LVIS
evaluation differs from COCO in: maxDets=300 per image (not 100), the
`not_exhaustive_category_ids`/`neg_category_ids` image-level annotations
(detections of categories not exhaustively annotated in an image are ignored),
and AP reported overall plus per frequency bucket (APr/APc/APf).
"""
import numpy as np

from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.cocoeval import COCOeval


class LVISEval(COCOeval):
    def __init__(self, lvis_gt: COCO, lvis_dt: COCO, iou_type="segm"):
        super().__init__(lvis_gt, lvis_dt, iou_type)
        self.params.maxDets = [300]
        # image-level negative / non-exhaustive annotations
        self._img_ne = {img["id"]: set(img.get("not_exhaustive_category_ids",
                                               []))
                        for img in lvis_gt.dataset.get("images", [])}
        self._img_neg = {img["id"]: set(img.get("neg_category_ids", []))
                         for img in lvis_gt.dataset.get("images", [])}
        freq = {}
        for cat in lvis_gt.dataset.get("categories", []):
            freq[cat["id"]] = cat.get("frequency", "f")
        self._freq = freq

    def _prepare(self):
        super()._prepare()
        # drop detections for categories negatively annotated in the image
        for (img_id, cat_id) in list(self._dts.keys()):
            if cat_id in self._img_neg.get(img_id, ()):  # known absent
                self._dts[img_id, cat_id] = []

    def _evaluate_img(self, img_id, cat_id, aRng, maxDet):
        out = super()._evaluate_img(img_id, cat_id, aRng, maxDet)
        if out is None:
            return None
        # non-exhaustive: unmatched detections are ignored, not FPs
        if cat_id in self._img_ne.get(img_id, ()):  # pragma: no cover
            dtm = out["dtMatches"]
            out["dtIgnore"] = np.logical_or(out["dtIgnore"], dtm == 0)
        return out

    def summarize(self):
        p = self.params
        prec = self.eval["precision"]  # [T, R, K, A, M]

        def ap(cat_mask=None, area=0):
            s = prec[:, :, :, area, -1]
            if cat_mask is not None:
                s = s[:, :, cat_mask]
            valid = s[s > -1]
            return float(valid.mean()) if valid.size else -1.0

        freqs = np.array([self._freq.get(c, "f") for c in p.catIds])
        stats = {
            "AP": ap(),
            "AP50": float(np.mean(prec[0, :, :, 0, -1]
                                  [prec[0, :, :, 0, -1] > -1]))
            if (prec[0, :, :, 0, -1] > -1).any() else -1.0,
            "APr": ap(freqs == "r"),
            "APc": ap(freqs == "c"),
            "APf": ap(freqs == "f"),
            "APs": ap(area=1),
            "APm": ap(area=2),
            "APl": ap(area=3),
        }
        for k, v in stats.items():
            print(f" {k:>5s} = {v:0.3f}")
        self.stats = stats
        return stats


def main(argv=None):
    """CLI: evaluate an exported results json against an LVIS-format GT json
    (the step the reference runs via the external `lvis` package after
    scripts/lvis pipelines export results)."""
    import argparse
    import json

    p = argparse.ArgumentParser(description="LVIS evaluation")
    p.add_argument("--gt", required=True, help="LVIS GT json")
    p.add_argument("--results", required=True, help="detections json")
    p.add_argument("--iou-type", default="segm", choices=("bbox", "segm"))
    a = p.parse_args(argv)

    gt = COCO(a.gt)
    with open(a.results) as f:
        dets = json.load(f)
    if not dets:
        print("No results to evaluate.")
        return None
    dt = gt.loadRes(dets)
    ev = LVISEval(gt, dt, a.iou_type)
    ev.evaluate()
    ev.accumulate()
    return ev.summarize()


if __name__ == "__main__":
    main()
