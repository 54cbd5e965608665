"""The port's own copy of `no_time_to_train_tpu/data/cocoeval.py`, so that the
port imports nothing of the JAX package.

COCO-style detection/segmentation evaluation (replacement for
pycocotools.cocoeval.COCOeval, which is not a dependency of this build;
the reference calls it at coco_ref_dataset.py:652-662).

Implements the standard COCO mAP protocol: greedy score-ordered matching per
(image, category) at IoU thresholds 0.5:0.05:0.95 with crowd/area-range/ignore
handling, 101-point interpolated precision, and the canonical 12-line summary.
"""
import copy
from collections import defaultdict

import numpy as np

from no_time_to_train_tpu_torch.data import rle as rle_mod


def bbox_iou_xywh(dt, gt, iscrowd):
    dt = np.asarray(dt, np.float64).reshape(-1, 4)
    gt = np.asarray(gt, np.float64).reshape(-1, 4)
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)))
    dx1, dy1 = dt[:, 0], dt[:, 1]
    dx2, dy2 = dt[:, 0] + dt[:, 2], dt[:, 1] + dt[:, 3]
    gx1, gy1 = gt[:, 0], gt[:, 1]
    gx2, gy2 = gt[:, 0] + gt[:, 2], gt[:, 1] + gt[:, 3]
    iw = np.clip(np.minimum(dx2[:, None], gx2) - np.maximum(dx1[:, None], gx1),
                 0, None)
    ih = np.clip(np.minimum(dy2[:, None], gy2) - np.maximum(dy1[:, None], gy1),
                 0, None)
    inter = iw * ih
    da = (dt[:, 2] * dt[:, 3])[:, None]
    ga = (gt[:, 2] * gt[:, 3])[None, :]
    crowd = np.asarray(iscrowd, bool)[None, :]
    union = np.where(crowd, da, da + ga - inter)
    return np.where(union > 0, inter / union, 0.0)


class Params:
    def __init__(self, iouType="segm"):
        self.imgIds = []
        self.catIds = []
        self.iouThrs = np.linspace(0.5, 0.95, 10)
        self.recThrs = np.linspace(0.0, 1.00, 101)
        self.maxDets = [1, 10, 100]
        self.areaRng = [[0, 1e5 ** 2], [0, 32 ** 2], [32 ** 2, 96 ** 2],
                        [96 ** 2, 1e5 ** 2]]
        self.areaRngLbl = ["all", "small", "medium", "large"]
        self.useCats = 1
        self.iouType = iouType


class COCOeval:
    def __init__(self, cocoGt, cocoDt, iouType="segm"):
        self.cocoGt = cocoGt
        self.cocoDt = cocoDt
        self.params = Params(iouType)
        self.params.imgIds = sorted(cocoGt.imgs.keys())
        self.params.catIds = sorted(cocoGt.cats.keys())
        self.evalImgs = {}
        self.eval = {}
        self.stats = []

    # ------------------------------------------------------------ prepare
    def _prepare(self):
        p = self.params
        gts = self.cocoGt.loadAnns(self.cocoGt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        dts = self.cocoDt.loadAnns(self.cocoDt.getAnnIds(
            imgIds=p.imgIds, catIds=p.catIds if p.useCats else []))
        gts = copy.deepcopy(gts)
        for g in gts:
            g["ignore"] = g.get("ignore", 0) or g.get("iscrowd", 0)
            if p.iouType == "segm":
                g["_rle"] = self.cocoGt.annToRLE(g)
        dts = copy.deepcopy(dts)
        self._gts = defaultdict(list)
        self._dts = defaultdict(list)
        for g in gts:
            self._gts[g["image_id"], g["category_id"]].append(g)
        for d in dts:
            self._dts[d["image_id"], d["category_id"]].append(d)

    def _compute_iou(self, img_id, cat_id):
        p = self.params
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 or len(dt) == 0:
            return np.zeros((len(dt), len(gt)))
        inds = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in inds][: p.maxDets[-1]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        if p.iouType == "segm":
            return rle_mod.iou_rle([d["segmentation"] for d in dt],
                                   [g["_rle"] for g in gt], iscrowd)
        return bbox_iou_xywh([d["bbox"] for d in dt],
                             [g["bbox"] for g in gt], iscrowd)

    # ----------------------------------------------------------- evaluate
    def evaluate(self):
        p = self.params
        p.imgIds = list(np.unique(p.imgIds))
        if p.useCats:
            p.catIds = list(np.unique(p.catIds))
        self._prepare()
        self.ious = {(i, c): self._compute_iou(i, c)
                     for i in p.imgIds for c in p.catIds}
        self.evalImgs = {}
        for c in p.catIds:
            for a_i, aRng in enumerate(p.areaRng):
                for i in p.imgIds:
                    self.evalImgs[i, c, a_i] = self._evaluate_img(
                        i, c, aRng, p.maxDets[-1])

    def _evaluate_img(self, img_id, cat_id, aRng, maxDet):
        p = self.params
        gt = self._gts[img_id, cat_id]
        dt = self._dts[img_id, cat_id]
        if len(gt) == 0 and len(dt) == 0:
            return None
        for g in gt:
            g["_ignore"] = 1 if (g["ignore"] or g["area"] < aRng[0]
                                 or g["area"] > aRng[1]) else 0
        gtind = np.argsort([g["_ignore"] for g in gt], kind="mergesort")
        gt = [gt[i] for i in gtind]
        dtind = np.argsort([-d["score"] for d in dt], kind="mergesort")
        dt = [dt[i] for i in dtind[:maxDet]]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gt]
        ious = self.ious[img_id, cat_id]
        ious = ious[:, gtind] if len(ious) > 0 else ious

        T = len(p.iouThrs)
        G = len(gt)
        D = len(dt)
        gtm = np.zeros((T, G))
        dtm = np.zeros((T, D))
        gtIg = np.array([g["_ignore"] for g in gt])
        dtIg = np.zeros((T, D))
        if len(ious) > 0:
            for tind, t in enumerate(p.iouThrs):
                for dind, d in enumerate(dt):
                    iou = min([t, 1 - 1e-10])
                    m = -1
                    for gind, g in enumerate(gt):
                        if gtm[tind, gind] > 0 and not iscrowd[gind]:
                            continue
                        if m > -1 and gtIg[m] == 0 and gtIg[gind] == 1:
                            break
                        if ious[dind, gind] < iou:
                            continue
                        iou = ious[dind, gind]
                        m = gind
                    if m == -1:
                        continue
                    dtIg[tind, dind] = gtIg[m]
                    dtm[tind, dind] = gt[m]["id"]
                    gtm[tind, m] = d["id"]
        a = np.array([d["area"] < aRng[0] or d["area"] > aRng[1]
                      for d in dt]).reshape(1, -1)
        dtIg = np.logical_or(dtIg, np.logical_and(dtm == 0,
                                                  np.repeat(a, T, 0)))
        return {
            "dtIds": [d["id"] for d in dt],
            "gtIds": [g["id"] for g in gt],
            "dtMatches": dtm,
            "gtMatches": gtm,
            "dtScores": [d["score"] for d in dt],
            "gtIgnore": gtIg,
            "dtIgnore": dtIg,
        }

    # --------------------------------------------------------- accumulate
    def accumulate(self):
        p = self.params
        T = len(p.iouThrs)
        R = len(p.recThrs)
        K = len(p.catIds)
        A = len(p.areaRng)
        M = len(p.maxDets)
        precision = -np.ones((T, R, K, A, M))
        recall = -np.ones((T, K, A, M))
        scores = -np.ones((T, R, K, A, M))

        for k, cat_id in enumerate(p.catIds):
            for a in range(A):
                E = [self.evalImgs.get((i, cat_id, a)) for i in p.imgIds]
                E = [e for e in E if e is not None]
                if len(E) == 0:
                    continue
                for m, maxDet in enumerate(p.maxDets):
                    dtScores = np.concatenate(
                        [e["dtScores"][:maxDet] for e in E])
                    inds = np.argsort(-dtScores, kind="mergesort")
                    dtScoresSorted = dtScores[inds]
                    dtm = np.concatenate(
                        [e["dtMatches"][:, :maxDet] for e in E], axis=1)[:, inds]
                    dtIg = np.concatenate(
                        [e["dtIgnore"][:, :maxDet] for e in E], axis=1)[:, inds]
                    gtIg = np.concatenate([e["gtIgnore"] for e in E])
                    npig = np.count_nonzero(gtIg == 0)
                    if npig == 0:
                        continue
                    tps = np.logical_and(dtm, np.logical_not(dtIg))
                    fps = np.logical_and(np.logical_not(dtm),
                                         np.logical_not(dtIg))
                    tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                    fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                    for t in range(T):
                        tp = tp_sum[t]
                        fp = fp_sum[t]
                        nd = len(tp)
                        rc = tp / npig
                        pr = tp / (fp + tp + np.spacing(1))
                        q = np.zeros((R,))
                        ss = np.zeros((R,))
                        recall[t, k, a, m] = rc[-1] if nd else 0
                        pr = pr.tolist()
                        for i in range(nd - 1, 0, -1):
                            if pr[i] > pr[i - 1]:
                                pr[i - 1] = pr[i]
                        inds_r = np.searchsorted(rc, p.recThrs, side="left")
                        for ri, pi in enumerate(inds_r):
                            if pi < nd:
                                q[ri] = pr[pi]
                                ss[ri] = dtScoresSorted[pi]
                        precision[t, :, k, a, m] = q
                        scores[t, :, k, a, m] = ss
        self.eval = {"precision": precision, "recall": recall,
                     "scores": scores, "params": p}

    # ---------------------------------------------------------- summarize
    def _summarize(self, ap=1, iouThr=None, areaRng="all", maxDets=100):
        p = self.params
        iStr = (" {:<18} {} @[ IoU={:<9} | area={:>6s} | maxDets={:>3d} ]"
                " = {:0.3f}")
        titleStr = "Average Precision" if ap == 1 else "Average Recall"
        typeStr = "(AP)" if ap == 1 else "(AR)"
        iouStr = ("{:0.2f}:{:0.2f}".format(p.iouThrs[0], p.iouThrs[-1])
                  if iouThr is None else "{:0.2f}".format(iouThr))
        aind = [i for i, a in enumerate(p.areaRngLbl) if a == areaRng]
        mind = [i for i, m in enumerate(p.maxDets) if m == maxDets]
        if ap == 1:
            s = self.eval["precision"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iouThr is not None:
                t = np.where(np.isclose(iouThr, p.iouThrs))[0]
                s = s[t]
            s = s[:, :, aind, mind]
        mean_s = -1 if len(s[s > -1]) == 0 else np.mean(s[s > -1])
        print(iStr.format(titleStr, typeStr, iouStr, areaRng, maxDets, mean_s))
        return mean_s

    def summarize(self):
        self.stats = np.array([
            self._summarize(1),
            self._summarize(1, iouThr=0.5, maxDets=self.params.maxDets[2]),
            self._summarize(1, iouThr=0.75, maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="small", maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="medium", maxDets=self.params.maxDets[2]),
            self._summarize(1, areaRng="large", maxDets=self.params.maxDets[2]),
            self._summarize(0, maxDets=self.params.maxDets[0]),
            self._summarize(0, maxDets=self.params.maxDets[1]),
            self._summarize(0, maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="small", maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="medium", maxDets=self.params.maxDets[2]),
            self._summarize(0, areaRng="large", maxDets=self.params.maxDets[2]),
        ])
        return self.stats
