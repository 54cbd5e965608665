"""The port's own copy of `no_time_to_train_tpu/data/few_shot_sampling.py`, so that the
port imports nothing of the JAX package.

Few-shot reference sampling -> memory pkl (reference
no_time_to_train/dataset/few_shot_sampling.py:16-139).

Produces {cat_id: [{img_id, ann_ids}]} pickles consumed by the fill-memory
datasets. Keeps the reference's semantics: validity filter (no crowd, >=32px
box, >=10px from borders), one annotation per image unless
prefer_multi_instance, LVIS-rare escape hatches (allow_duplicates /
allow_invalid).
"""
import argparse
import pickle
import random

from no_time_to_train_tpu_torch.data.coco_api import COCO
from no_time_to_train_tpu_torch.data.data_utils import is_valid_annotation
from no_time_to_train_tpu_torch.data.metainfo import METAINFO


def sample_memory_dataset(json_file, out_path, memory_length, remove_bad,
                          dataset="coco", allow_duplicates=False,
                          allow_invalid=False, prefer_multi_instance=False,
                          seed=None):
    if seed is not None:
        random.seed(seed)
    coco = COCO(json_file)
    split = {"coco": "default_classes"}.get(dataset, dataset)
    names = METAINFO.get(split, METAINFO["default_classes"])
    cat_ids = coco.getCatIds(catNms=names)

    cat_to_imgs_and_anns = {}
    for ann_id, ann in coco.anns.items():
        if ann["category_id"] not in cat_ids:
            continue
        if remove_bad and ann.get("isimpossible", 0) == 1:
            continue
        cat_to_imgs_and_anns.setdefault(ann["category_id"], []).append(
            (ann["image_id"], ann_id))

    sampled = {}
    for cat_id, cat_data in cat_to_imgs_and_anns.items():
        sampled[cat_id] = []
        invalid = []
        if prefer_multi_instance:
            img_to_ann_ids = {}
            for img_id, ann_id in cat_data:
                info = coco.loadImgs([img_id])[0]
                if not is_valid_annotation(coco.loadAnns([ann_id])[0], info):
                    if allow_invalid:
                        invalid.append({"img_id": img_id, "ann_ids": [ann_id]})
                    continue
                img_to_ann_ids.setdefault(img_id, []).append(ann_id)
            items = list(img_to_ann_ids.items())
            random.shuffle(items)
            items.sort(key=lambda kv: len(kv[1]), reverse=True)
            for img_id, ann_ids in items:
                for ann_id in ann_ids:
                    sampled[cat_id].append({"img_id": img_id,
                                            "ann_ids": [ann_id]})
                    if len(sampled[cat_id]) >= memory_length:
                        break
                if len(sampled[cat_id]) >= memory_length:
                    break
        else:
            seen_imgs = []
            random.shuffle(cat_data)
            for img_id, ann_id in cat_data:
                info = coco.loadImgs([img_id])[0]
                if not is_valid_annotation(coco.loadAnns([ann_id])[0], info):
                    if allow_invalid:
                        invalid.append({"img_id": img_id, "ann_ids": [ann_id]})
                    continue
                if img_id in seen_imgs:
                    continue
                seen_imgs.append(img_id)
                sampled[cat_id].append({"img_id": img_id, "ann_ids": [ann_id]})
                if len(seen_imgs) >= memory_length:
                    break

        if len(sampled[cat_id]) < memory_length:
            if len(sampled[cat_id]) == 0 and allow_invalid:
                print(f"Warning: class {cat_id} has no valid samples; using "
                      f"{len(invalid)} invalid ones.")
                sampled[cat_id] = invalid[:memory_length]
            if allow_duplicates:
                need = memory_length - len(sampled[cat_id])
                print(f"Warning: class {cat_id} short by {need}; duplicating.")
                for i in range(need):
                    sampled[cat_id].append(sampled[cat_id][i])
            elif len(sampled[cat_id]) < memory_length:
                raise ValueError(f"Reference for class {cat_id} is not enough")

    with open(out_path, "wb") as fw:
        pickle.dump(sampled, fw)
    print(f"Results output to: {out_path}")
    return sampled


DEFAULT_JSONS = {
    "coco": "./data/coco/annotations/instances_train2017.json",
    "lvis": "./data/lvis/lvis_v1_train.json",
    "pascal_voc": "./data/pascal_voc/annotations/voc0712_trainval_with_segm.json",
    "olive_diseases": "./data/olive_diseases/train/_annotations.coco.json",
}


def main():
    """Reference-compatible CLI (few_shot_sampling.py:269-340): per-dataset
    default json paths, LVIS gets allow_duplicates/allow_invalid, COCO/VOC/
    olive remove_bad."""
    p = argparse.ArgumentParser(description="Sample few-shot memory dataset")
    p.add_argument("--n-shot", type=int, required=True)
    p.add_argument("--out-path", required=True)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dataset", default="coco")
    p.add_argument("--dataset-json", default=None)
    p.add_argument("--prefer-multi-instance", action="store_true")
    a = p.parse_args()

    ds = a.dataset
    if ds.startswith("lvis"):
        json_file = a.dataset_json or DEFAULT_JSONS["lvis"]
        kwargs = dict(remove_bad=False, allow_duplicates=True,
                      allow_invalid=True)
    elif ds.startswith("pascal_voc"):
        json_file = a.dataset_json or DEFAULT_JSONS["pascal_voc"]
        kwargs = dict(remove_bad=True)
    elif ds == "olive_diseases":
        json_file = a.dataset_json or DEFAULT_JSONS["olive_diseases"]
        kwargs = dict(remove_bad=True)
    else:
        json_file = a.dataset_json or DEFAULT_JSONS["coco"]
        kwargs = dict(remove_bad=True)
    sample_memory_dataset(json_file, a.out_path, a.n_shot, dataset=ds,
                          prefer_multi_instance=a.prefer_multi_instance,
                          seed=a.seed, **kwargs)


if __name__ == "__main__":
    main()
