"""The port's own copy of `no_time_to_train_tpu/data/coco_api.py`, so that the
port imports nothing of the JAX package.

Minimal COCO API (replacement for pycocotools.coco.COCO, which is not a
dependency of this build). Implements the subset the framework uses:
index construction, getCatIds/getAnnIds/getImgIds, loadAnns/loadImgs/loadCats,
annToRLE/annToMask, loadRes.

Polygon rasterization uses pixel-center even-odd scanline filling. This is the
one documented numerical deviation from pycocotools (whose C rasterizer has
slightly different boundary-pixel conventions); differences are confined to
polygon boundary pixels and are well inside the AP tolerance budget.
"""
import copy
import json
from collections import defaultdict

import numpy as np

from no_time_to_train_tpu_torch.data import rle as rle_mod


def rasterize_polygons(polys, h, w):
    """polys: list of flat [x0,y0,x1,y1,...] lists -> [H, W] uint8 even-odd
    filled mask at pixel centers, union over polygons."""
    mask = np.zeros((h, w), np.uint8)
    for poly in polys:
        xy = np.asarray(poly, np.float64).reshape(-1, 2)
        if len(xy) < 3:
            continue
        x0, y0 = xy[:, 0], xy[:, 1]
        x1 = np.roll(x0, -1)
        y1 = np.roll(y0, -1)
        ys = np.arange(h) + 0.5  # pixel centers
        # edges crossing each scanline (half-open [min, max) rule)
        ymin = np.minimum(y0, y1)[None, :]
        ymax = np.maximum(y0, y1)[None, :]
        crosses = (ys[:, None] >= ymin) & (ys[:, None] < ymax)
        denom = (y1 - y0)[None, :]
        with np.errstate(divide="ignore", invalid="ignore"):
            t = (ys[:, None] - y0[None, :]) / denom
        xint = x0[None, :] + t * (x1 - x0)[None, :]
        xint = np.where(crosses, xint, np.inf)
        xint.sort(axis=1)
        xs = np.arange(w) + 0.5
        for row in range(h):
            vals = xint[row]
            vals = vals[np.isfinite(vals)]
            if len(vals) < 2:
                continue
            inside = np.zeros(w, bool)
            for a, b in zip(vals[0::2], vals[1::2]):
                inside |= (xs >= a) & (xs < b)
            mask[row] |= inside
    return mask


class COCO:
    def __init__(self, annotation_file=None):
        self.dataset = {}
        self.anns, self.cats, self.imgs = {}, {}, {}
        self.imgToAnns = defaultdict(list)
        self.catToImgs = defaultdict(list)
        if annotation_file is not None:
            with open(annotation_file) as f:
                self.dataset = json.load(f)
            self.createIndex()

    def createIndex(self):
        anns, cats, imgs = {}, {}, {}
        imgToAnns = defaultdict(list)
        catToImgs = defaultdict(list)
        for ann in self.dataset.get("annotations", []):
            imgToAnns[ann["image_id"]].append(ann)
            anns[ann["id"]] = ann
        for img in self.dataset.get("images", []):
            imgs[img["id"]] = img
        for cat in self.dataset.get("categories", []):
            cats[cat["id"]] = cat
        for ann in self.dataset.get("annotations", []):
            catToImgs[ann["category_id"]].append(ann["image_id"])
        self.anns, self.cats, self.imgs = anns, cats, imgs
        self.imgToAnns, self.catToImgs = imgToAnns, catToImgs

    # ------------------------------------------------------------- getters
    def getCatIds(self, catNms=(), supNms=(), catIds=()):
        catNms, supNms, catIds = [list(x) for x in (catNms, supNms, catIds)]
        cats = list(self.dataset.get("categories", []))
        if catNms:
            cats = [c for c in cats if c["name"] in catNms]
        if supNms:
            cats = [c for c in cats if c.get("supercategory") in supNms]
        if catIds:
            cats = [c for c in cats if c["id"] in catIds]
        return [c["id"] for c in cats]

    def getAnnIds(self, imgIds=(), catIds=(), areaRng=(), iscrowd=None):
        imgIds = [imgIds] if isinstance(imgIds, int) else list(imgIds)
        catIds = [catIds] if isinstance(catIds, int) else list(catIds)
        if imgIds:
            anns = [a for i in imgIds for a in self.imgToAnns[i]]
        else:
            anns = list(self.dataset.get("annotations", []))
        if catIds:
            cset = set(catIds)
            anns = [a for a in anns if a["category_id"] in cset]
        if areaRng:
            anns = [a for a in anns
                    if areaRng[0] < a["area"] < areaRng[1]]
        if iscrowd is not None:
            anns = [a for a in anns if a.get("iscrowd", 0) == iscrowd]
        return [a["id"] for a in anns]

    def getImgIds(self, imgIds=(), catIds=()):
        imgIds = [imgIds] if isinstance(imgIds, int) else list(imgIds)
        catIds = [catIds] if isinstance(catIds, int) else list(catIds)
        ids = set(imgIds) if imgIds else set(self.imgs.keys())
        for i, cid in enumerate(catIds):
            s = set(self.catToImgs[cid])
            ids = s if (i == 0 and not imgIds) else ids & s
        return list(ids)

    def loadAnns(self, ids):
        if isinstance(ids, int):
            return [self.anns[ids]]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if isinstance(ids, int):
            return [self.imgs[ids]]
        return [self.imgs[i] for i in ids]

    def loadCats(self, ids):
        if isinstance(ids, int):
            return [self.cats[ids]]
        return [self.cats[i] for i in ids]

    # --------------------------------------------------------------- masks
    def annToRLE(self, ann):
        img = self.imgs[ann["image_id"]]
        h, w = img["height"], img["width"]
        segm = ann["segmentation"]
        if isinstance(segm, list):
            mask = rasterize_polygons(segm, h, w)
            return rle_mod.encode_mask(mask)
        if isinstance(segm.get("counts"), list):
            return {"size": segm["size"],
                    "counts": rle_mod.rle_to_string(segm["counts"])}
        return segm

    def annToMask(self, ann):
        return rle_mod.decode_rle(self.annToRLE(ann))

    # ------------------------------------------------------------- results
    def loadRes(self, resFile):
        """Detection results (list of dicts or json path) -> result COCO."""
        res = COCO()
        res.dataset = {"images": [img for img in self.dataset["images"]]}
        if isinstance(resFile, str):
            with open(resFile) as f:
                anns = json.load(f)
        else:
            anns = copy.deepcopy(list(resFile))
        assert isinstance(anns, list)
        img_ids_set = set(self.imgs.keys())
        for a in anns:
            assert a["image_id"] in img_ids_set
        res.dataset["categories"] = copy.deepcopy(
            self.dataset.get("categories", []))
        for i, a in enumerate(anns):
            if "segmentation" in a and "bbox" not in a:
                rle = a["segmentation"]
                m = rle_mod.decode_rle(rle)
                ys, xs = np.nonzero(m)
                if len(ys):
                    a["bbox"] = [float(xs.min()), float(ys.min()),
                                 float(xs.max() - xs.min() + 1),
                                 float(ys.max() - ys.min() + 1)]
                else:
                    a["bbox"] = [0.0, 0.0, 0.0, 0.0]
            if "area" not in a:
                if "segmentation" in a:
                    a["area"] = rle_mod.area(a["segmentation"]) \
                        if not isinstance(a["segmentation"], list) else 0
                else:
                    bb = a["bbox"]
                    a["area"] = bb[2] * bb[3]
            a["id"] = i + 1
            a.setdefault("iscrowd", 0)
        res.dataset["annotations"] = anns
        res.createIndex()
        return res
