"""COCO-style datasets for the three pipeline phases (numpy / NHWC
outputs): the port of `no_time_to_train_tpu/data/datasets.py`.

Behavioral ports of reference no_time_to_train/dataset/coco_ref_dataset.py:
  - COCOMemoryFillCropDataset (:408) — THE live fill-memory dataset: square
    crop around the annotation bbox with context_ratio, bicubic image resize +
    bilinear mask resize to image_size.
  - COCOMemoryFillDataset (:312) — whole-image variant (semantic_ref support).
  - COCORefTestDataset (:498) — class-split-filtered test set with
    encode_results/evaluate.
  - COCORefOracleTestDataset (:758) — test set + GT annotations for vis/oracle.
  - COCORefTrainDataset (:56-308) — the SAM2Ref variant's training set.

Image loading matches sam2/utils/misc.py:_load_img_as_tensor (:92-107): RGB,
PIL's default-resample square resize, /255. The port decodes PNG itself and
resizes with `image_io.resize_like_pil`, bit for bit PIL's resize, so it
needs PIL only to decode JPEG.
"""
import copy
import json
import os
import pickle
from collections import OrderedDict

import numpy as np

from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.cocoeval import COCOeval
from no_time_to_train_tpu_torch.data import rle as rle_mod
from no_time_to_train_tpu_torch.data.image_io import read_rgb, resize_like_pil
from no_time_to_train_tpu_torch.data.metainfo import METAINFO

IMG_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMG_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(img_path, image_size=None, normalize=False):
    """-> ([H, W, 3] float32 in [0,1] (optionally ImageNet-normalized),
    ori_h, ori_w). image_size None keeps the original size."""
    rgb = read_rgb(img_path)
    oh, ow = rgb.shape[:2]
    if image_size is not None:
        if isinstance(image_size, int):
            image_size = (image_size, image_size)
        rgb = resize_like_pil(rgb, image_size)
    arr = np.asarray(rgb).astype(np.float32) / 255.0
    if normalize:
        arr = (arr - IMG_MEAN) / IMG_STD
    return arr, oh, ow


def _get_cat_inds(cat_ids):
    cat_ids = sorted(cat_ids)
    return ({cid: i for i, cid in enumerate(cat_ids)},
            {i: cid for i, cid in enumerate(cat_ids)})


def _resolve_cat_names(class_split, cat_names):
    if cat_names:
        return list(cat_names)
    if class_split is None:
        return list(METAINFO["default_classes"])
    return list(METAINFO[class_split])


def _resize_mask_nearest(mask, out_hw):
    h, w = mask.shape
    oh, ow = out_hw
    yi = np.floor(np.arange(oh) * (h / oh)).astype(np.int64).clip(0, h - 1)
    xi = np.floor(np.arange(ow) * (w / ow)).astype(np.int64).clip(0, w - 1)
    return mask[yi][:, xi]


def _resize_mask_bilinear(mask, out_hw):
    from no_time_to_train_tpu_torch.ops.resize import _resize_matrix_np
    h, w = mask.shape
    oh, ow = out_hw
    wh = _resize_matrix_np(h, oh, "bilinear", False).astype(np.float32)
    ww = _resize_matrix_np(w, ow, "bilinear", False).astype(np.float32)
    return wh @ mask.astype(np.float32) @ ww.T


def _resize_image_bicubic(img_hwc, out_hw):
    """torch F.interpolate(mode='bicubic') parity on host (numpy)."""
    from no_time_to_train_tpu_torch.ops.resize import _resize_matrix_np
    h, w, _ = img_hwc.shape
    oh, ow = out_hw
    wh = _resize_matrix_np(h, oh, "bicubic", False).astype(np.float32)
    ww = _resize_matrix_np(w, ow, "bicubic", False).astype(np.float32)
    return np.einsum("oh,hwc->owc", wh,
                     np.einsum("ow,hwc->hoc", ww, img_hwc.astype(np.float32)))


class COCOMemoryFillCropDataset:
    """Yields one reference crop per item: dict(data_mode, cat_ind,
    img [S, S, 3], mask [S, S], img_info)."""

    def __init__(self, root, json_file, memory_pkl, image_size, memory_length,
                 context_ratio=0.1, norm_img=False, class_split=None,
                 cat_names=(), custom_data_mode=None, semantic_ref=False):
        assert not semantic_ref
        self.root = root
        self.coco = COCO(json_file)
        with open(memory_pkl, "rb") as f:
            self.sampled_memory_data = pickle.load(f)
        self.image_size = image_size
        self.norm_img = norm_img
        self.memory_length = memory_length
        self.context_ratio = context_ratio
        self.cat_names = _resolve_cat_names(class_split, cat_names)
        self.cat_ids = self.coco.getCatIds(catNms=self.cat_names)
        self.cat_ids_to_inds, self.cat_inds_to_ids = _get_cat_inds(self.cat_ids)
        self.data_mode = custom_data_mode or "fill_memory"

        for cat_id, refs in self.sampled_memory_data.items():
            if len(refs) != memory_length:
                raise ValueError(
                    f"Category {cat_id}: {len(refs)} references but memory "
                    f"length is {memory_length}")
        self.all_data = []
        for cat_id, refs in self.sampled_memory_data.items():
            if cat_id not in self.cat_ids:
                continue
            for d in refs:
                d = dict(d)
                d["category_id"] = cat_id
                self.all_data.append(d)

    def __len__(self):
        return len(self.all_data)

    def __getitem__(self, index):
        d = self.all_data[index]
        img_info = self.coco.loadImgs([d["img_id"]])[0]
        oh, ow = img_info["height"], img_info["width"]
        img, _, _ = load_image(os.path.join(self.root, img_info["file_name"]),
                               image_size=(oh, ow), normalize=self.norm_img)
        ann = self.coco.loadAnns(d["ann_ids"])[0]
        assert ann["category_id"] == d["category_id"]
        mask = self.coco.annToMask(ann).astype(np.float32)
        bx, by, bw, bh = ann["bbox"]
        x1, y1, x2, y2 = int(bx), int(by), int(bx + bw), int(by + bh)

        # square crop with context, aspect preserved (reference :452-459)
        mid_x, mid_y = (x1 + x2) * 0.5, (y1 + y2) * 0.5
        crop = max(x2 - x1, y2 - y1) * (1.0 + self.context_ratio)
        cx1 = max(0, int(mid_x - crop * 0.5))
        cy1 = max(0, int(mid_y - crop * 0.5))
        cx2 = min(ow, int(mid_x + crop * 0.5))
        cy2 = min(oh, int(mid_y + crop * 0.5))

        img_crop = img[cy1:cy2, cx1:cx2]
        mask_crop = mask[cy1:cy2, cx1:cx2]
        s = self.image_size
        img_crop = _resize_image_bicubic(img_crop, (s, s))
        mask_crop = _resize_mask_bilinear(mask_crop, (s, s))

        return OrderedDict(
            data_mode=self.data_mode,
            cat_ind=self.cat_ids_to_inds[d["category_id"]],
            img=img_crop, mask=mask_crop,
            img_info=dict(ori_height=oh, ori_width=ow,
                          file_name=img_info["file_name"], id=d["img_id"]))


class COCOMemoryFillDataset(COCOMemoryFillCropDataset):
    """Whole-image fill variant (reference :312-405), with optional
    semantic_ref union-of-instances masks."""

    def __init__(self, root, json_file, memory_pkl, image_size, memory_length,
                 semantic_ref=False, norm_img=False, class_split=None,
                 cat_names=(), custom_data_mode=None):
        super().__init__(root, json_file, memory_pkl, image_size,
                         memory_length, context_ratio=0.0, norm_img=norm_img,
                         class_split=class_split, cat_names=cat_names,
                         custom_data_mode=custom_data_mode)
        self.semantic_ref = semantic_ref

    def __getitem__(self, index):
        d = self.all_data[index]
        img_info = self.coco.loadImgs([d["img_id"]])[0]
        oh, ow = img_info["height"], img_info["width"]
        s = self.image_size
        img, _, _ = load_image(os.path.join(self.root, img_info["file_name"]),
                               image_size=s, normalize=self.norm_img)
        anns = self.coco.loadAnns(d["ann_ids"])
        masks = []
        for ann in anns:
            assert ann["category_id"] == d["category_id"]
            m = self.coco.annToMask(ann).astype(np.float32)
            masks.append(_resize_mask_nearest(m, (s, s)))
            if not self.semantic_ref:
                break
        mask = np.maximum.reduce(masks)
        return OrderedDict(
            data_mode=self.data_mode,
            cat_ind=self.cat_ids_to_inds[d["category_id"]],
            img=img, mask=mask,
            img_info=dict(ori_height=oh, ori_width=ow,
                          file_name=img_info["file_name"], id=d["img_id"]))


class COCORefTestDataset:
    def __init__(self, root, json_file, image_size, n_points_per_edge=16,
                 norm_img=False, class_split=None, with_query_points=False,
                 custom_data_mode=None, cat_names=()):
        with open(json_file) as jf:
            self.categories_ori = json.load(jf)["categories"]
        self.ann_json_file = json_file
        self.cat_names = _resolve_cat_names(class_split, cat_names)
        self.class_split = class_split or "default_classes"

        base = COCO(json_file)
        if self.class_split != "default_classes":
            cat_ids = base.getCatIds(catNms=self.cat_names)
            ann_ids = base.getAnnIds(catIds=cat_ids)
            filtered = base.loadAnns(ann_ids)
            self.coco = COCO()
            self.coco.dataset = dict(base.dataset)
            self.coco.dataset["annotations"] = filtered
            self.coco.createIndex()
        else:
            self.coco = base
        self.coco.dataset.setdefault("info", {})
        self.coco.dataset.setdefault("licenses", [])

        self.root = root
        self.img_ids = sorted(self.coco.imgs.keys())
        self.cat_ids = self.coco.getCatIds(catNms=self.cat_names)
        self.cat_ids_to_inds, self.cat_inds_to_ids = _get_cat_inds(self.cat_ids)
        self.image_size = image_size
        self.norm_img = norm_img
        self.n_points_per_edge = n_points_per_edge
        self.with_query_points = with_query_points
        self.data_mode = custom_data_mode or "test"

        self.img_to_anns = {i: [a["id"] for a in self.coco.imgToAnns[i]]
                            for i in self.img_ids}

    def __len__(self):
        return len(self.img_ids)

    def __getitem__(self, index):
        img_id = self.img_ids[index]
        info = self.coco.loadImgs([img_id])[0]
        img, _, _ = load_image(os.path.join(self.root, info["file_name"]),
                               image_size=self.image_size,
                               normalize=self.norm_img)
        ret = OrderedDict(
            data_mode=self.data_mode, target_img=img,
            target_img_info=dict(ori_height=info["height"],
                                 ori_width=info["width"],
                                 file_name=info["file_name"], id=img_id))
        if self.with_query_points:
            s = self.image_size
            x, y = np.meshgrid(np.linspace(0, s, self.n_points_per_edge),
                               np.linspace(0, s, self.n_points_per_edge))
            ret["query_points"] = np.stack(
                (x.reshape(-1), y.reshape(-1)), axis=-1) + 0.5
        return ret

    # ---------------------------------------------------------- results/eval
    def encode_results(self, output_dicts):
        """Reference encode_results (:590-613): numpy masks -> COCO RLE json
        records, labels mapped back to dataset category ids. Accepts
        pre-encoded RLEs under "segs" (the fused native finalize path,
        pipeline.finalize_records) in place of "masks"."""
        results = []
        for out in output_dicts:
            img_id = out["img_id"]
            img_id = int(img_id) if str(img_id).isdigit() else img_id
            for i in range(len(out["scores"])):
                box = np.asarray(out["boxes"][i], np.float64)
                seg = out["segs"][i] if "segs" in out else rle_mod.encode_mask(
                    np.asarray(out["masks"][i]).astype(np.uint8))
                results.append({
                    "image_id": img_id,
                    "category_id": int(self.cat_inds_to_ids[int(out["labels"][i])]),
                    "bbox": [float(box[0]), float(box[1]),
                             float(box[2] - box[0]), float(box[3] - box[1])],
                    "score": float(out["scores"][i]),
                    "segmentation": seg,
                })
        return results

    def evaluate(self, results, output_name=""):
        if output_name:
            os.makedirs("inst_to_segm", exist_ok=True)
            with open(f"inst_to_segm/coco_inst_{output_name}_results.json",
                      "w") as f:
                json.dump(results, f)
        if not results:
            print("No results to evaluate.")
            return None
        coco_results = self.coco.loadRes(results)
        if self.class_split == "default_classes":
            # reference runs tidecv BOX+MASK for the full-class split
            # (coco_ref_dataset.py:638-648); native equivalent in data/tide.py
            try:
                from no_time_to_train_tpu_torch.data.tide import evaluate_tide
                evaluate_tide(self.coco, results)
            except Exception as e:   # error analysis is advisory only
                print(f"TIDE analysis skipped: {e}")
        stats = {}
        for iou_type in ("bbox", "segm"):
            ev = COCOeval(self.coco, coco_results, iou_type)
            ev.params.imgIds = self.img_ids
            ev.evaluate()
            ev.accumulate()
            ev.summarize()
            stats[iou_type] = ev.stats
        return stats

    def sample_negative(self, results, out_pkl, out_json, sample_num,
                        score_thr=0.0):
        """False-positive mining for negative references (reference :665-755)."""
        from no_time_to_train_tpu_torch.data.data_utils import get_false_positives
        coco_results = self.coco.loadRes(results)
        fp_results = {c: [] for c in self.cat_ids}
        res_by_img = {}
        for ann in coco_results.anns.values():
            res_by_img.setdefault(ann["image_id"], []).append(ann)
        for img_id, res in res_by_img.items():
            anns = self.coco.loadAnns(self.img_to_anns.get(img_id, []))
            fps = get_false_positives(res, anns, self.cat_ids, iou_thr=0.1)
            for c in self.cat_ids:
                fp_results[c].extend(fps[c])
        for c in self.cat_ids:
            if len(fp_results[c]) < sample_num:
                raise RuntimeError(
                    f"Category {c} does not have enough false positives!")
        out_pkl_dict = {}
        out_json_dict = {"images": [], "categories":
                         copy.deepcopy(self.categories_ori),
                         "annotations": []}
        ann_id = 1
        for c in self.cat_ids:
            cands = sorted(fp_results[c], key=lambda a: -a["score"])
            picked = [a for a in cands if a["score"] > score_thr][:sample_num]
            out_pkl_dict[c] = []
            for a in picked:
                a = dict(a)
                a["id"] = ann_id
                out_json_dict["annotations"].append(a)
                out_pkl_dict[c].append(
                    dict(img_id=a["image_id"], ann_ids=[ann_id]))
                ann_id += 1
        seen = set()
        for a in out_json_dict["annotations"]:
            if a["image_id"] not in seen:
                seen.add(a["image_id"])
                out_json_dict["images"].append(
                    self.coco.loadImgs([a["image_id"]])[0])
        with open(out_pkl, "wb") as f:
            pickle.dump(out_pkl_dict, f)
        with open(out_json, "w") as f:
            json.dump(out_json_dict, f)
        return out_pkl_dict


class COCORefOracleTestDataset(COCORefTestDataset):
    """Adds GT annotations per category (reference :758-807) for online vis
    and oracle analyses."""

    def __getitem__(self, index):
        ret = super().__getitem__(index)
        img_id = self.img_ids[index]
        info = self.coco.loadImgs([img_id])[0]
        s = self.image_size
        anns_by_cat = OrderedDict()
        for ann in self.coco.loadAnns(self.img_to_anns.get(img_id, [])):
            cat_ind = self.cat_ids_to_inds[ann["category_id"]]
            mask = _resize_mask_nearest(
                self.coco.annToMask(ann).astype(np.float32), (s, s))
            bx, by, bw, bh = ann["bbox"]
            box = np.array([bx * s / info["width"], by * s / info["height"],
                            (bx + bw) * s / info["width"],
                            (by + bh) * s / info["height"]], np.float32)
            entry = anns_by_cat.setdefault(cat_ind,
                                           {"masks": [], "bboxes": []})
            entry["masks"].append(mask)
            entry["bboxes"].append(box)
        for e in anns_by_cat.values():
            e["masks"] = np.stack(e["masks"])
            e["bboxes"] = np.stack(e["bboxes"])
        ret["tar_anns_by_cat"] = anns_by_cat
        return ret


class COCORefTrainDataset:
    """Training dataset for the SAM2Ref variant (reference
    coco_ref_dataset.py:56-308): per item, a target image with per-category
    GT masks, sampled pos/neg query points, and per-category random reference
    images with instance masks. Sampling draws from `random.Random(seed)`
    in the JAX package's order, so one seed gives its items."""

    def __init__(self, root, json_file, image_size, remove_bad=False,
                 max_cat_num=-1, max_mem_length=1, n_pos_points=8,
                 neg_ratio=1.0, norm_img=False, class_split=None,
                 cat_names=(), seed=None):
        import random as _random
        self.rng = _random.Random(seed)
        self.root = root
        self.coco = COCO(json_file)
        self.image_size = image_size
        self.norm_img = norm_img
        self.n_pos_points = n_pos_points
        self.neg_ratio = neg_ratio
        self.max_cat_num = max_cat_num
        self.max_mem_length = max_mem_length
        self.cat_names = _resolve_cat_names(class_split, cat_names)
        self.cat_ids = self.coco.getCatIds(catNms=self.cat_names)
        self.cat_ids_to_inds, self.cat_inds_to_ids = _get_cat_inds(self.cat_ids)

        self.img_ids = []
        self.img_to_anns = {}
        self.img_to_cats = {}
        self.cat_to_imgs_and_anns = {}
        for ann_id, ann in self.coco.anns.items():
            if ann["category_id"] not in self.cat_ids:
                continue
            if remove_bad and ann.get("isimpossible", 0) == 1:
                continue
            iid, cid = ann["image_id"], ann["category_id"]
            if iid not in self.img_to_anns:
                self.img_to_anns[iid] = []
                self.img_to_cats[iid] = []
                self.img_ids.append(iid)
            self.img_to_anns[iid].append(ann_id)
            if cid not in self.img_to_cats[iid]:
                self.img_to_cats[iid].append(cid)
            self.cat_to_imgs_and_anns.setdefault(cid, []).append((iid, ann_id))

    def __len__(self):
        return len(self.img_ids)

    def _sample_points(self, mask_union):
        """pos/neg/pad query-point sampling (reference :151-182); points are
        (x, y)."""
        pos = np.argwhere(mask_union > 0)
        if len(pos) == 0:
            raise ValueError("No positive points!")
        n_pos = min(len(pos), self.n_pos_points)
        sel = self.rng.sample(range(len(pos)), n_pos)
        pts = [pos[i][::-1] for i in sel]
        n_total = int(self.n_pos_points * (self.neg_ratio + 1))
        neg = np.argwhere(mask_union <= 0)
        n_neg = min(len(neg), n_total - n_pos)
        if n_neg > 0:
            sel = self.rng.sample(range(len(neg)), n_neg)
            pts += [neg[i][::-1] for i in sel]
        while len(pts) < n_total:  # pad with uniform random points
            pts.append([self.rng.randrange(mask_union.shape[1]),
                        self.rng.randrange(mask_union.shape[0])])
        return np.asarray(pts, np.float32)

    def _mask(self, ann):
        s = self.image_size
        return _resize_mask_nearest(
            self.coco.annToMask(ann).astype(np.float32), (s, s))

    def __getitem__(self, index):
        img_id = self.img_ids[index]
        info = self.coco.loadImgs([img_id])[0]
        s = self.image_size
        img, _, _ = load_image(os.path.join(self.root, info["file_name"]),
                               image_size=s, normalize=self.norm_img)
        cats = list(self.img_to_cats[img_id])
        if 0 < self.max_cat_num < len(cats):
            self.rng.shuffle(cats)
            cats = cats[: self.max_cat_num]

        tar_anns_by_cat = OrderedDict()
        for ann in self.coco.loadAnns(self.img_to_anns[img_id]):
            if ann["category_id"] not in cats:
                continue
            cat_ind = self.cat_ids_to_inds[ann["category_id"]]
            tar_anns_by_cat.setdefault(cat_ind, {"masks": []})[
                "masks"].append(self._mask(ann))
        for e in tar_anns_by_cat.values():
            e["masks"] = np.stack(e["masks"])
            e["query_points"] = self._sample_points(e["masks"].max(0))

        refs_by_cat = OrderedDict()
        for cat_id in cats:
            cat_ind = self.cat_ids_to_inds[cat_id]
            pool = self.cat_to_imgs_and_anns[cat_id]
            n_ref = min(self.max_mem_length, len(pool))
            picks, seen = [], set()
            for iid, aid in self.rng.sample(pool, len(pool)):
                if iid == img_id or iid in seen:
                    continue
                seen.add(iid)
                picks.append((iid, aid))
                if len(picks) >= n_ref:
                    break
            imgs, masks = [], []
            for iid, aid in picks:
                rinfo = self.coco.loadImgs([iid])[0]
                rimg, _, _ = load_image(
                    os.path.join(self.root, rinfo["file_name"]),
                    image_size=s, normalize=self.norm_img)
                imgs.append(rimg)
                masks.append(self._mask(self.coco.loadAnns([aid])[0]))
            if imgs:
                refs_by_cat[cat_ind] = {"imgs": np.stack(imgs),
                                        "masks": np.stack(masks)}

        return OrderedDict(
            data_mode="train", target_img=img,
            target_img_info=dict(ori_height=info["height"],
                                 ori_width=info["width"],
                                 file_name=info["file_name"], id=img_id),
            tar_anns_by_cat=tar_anns_by_cat, refs_by_cat=refs_by_cat)
