"""Small dataset utilities (port of
`no_time_to_train_tpu/data/dataset_tools.py`; behavioral ports of the reference's one-off
scripts: download_dataset.py, get_olive_classes.py, make_custom_dataset.py,
rename_olive_files.py, change_filename_pascal.py, merge_olive_datasets.py,
sample_memory_semantic_ref.py, cd_vito_paper_coco_zeroshot_categories data)."""
import json
import os
import pickle
import shutil
import urllib.request
from collections import OrderedDict
from multiprocessing.pool import ThreadPool
from pathlib import Path
from zipfile import ZipFile

COCO2017_URLS = [
    "http://images.cocodataset.org/zips/train2017.zip",
    "http://images.cocodataset.org/zips/val2017.zip",
    "http://images.cocodataset.org/annotations/annotations_trainval2017.zip",
]


def download_dataset(dataset_name="coco2017", save_dir=None, unzip=True,
                     delete=False, threads=4):
    """Threaded dataset downloader (reference download_dataset.py:124)."""
    save_dir = Path(save_dir or f"./data/{dataset_name}")
    save_dir.mkdir(parents=True, exist_ok=True)
    urls = {"coco2017": COCO2017_URLS}[dataset_name]

    def fetch(url):
        out = save_dir / url.split("/")[-1]
        if not out.exists():
            print(f"downloading {url}")
            urllib.request.urlretrieve(url, out)
        if unzip:
            ZipFile(out).extractall(path=save_dir)
            if delete:
                out.unlink()
        return out

    with ThreadPool(threads) as pool:
        return list(pool.map(fetch, urls))


def get_classes(json_path):
    """Category names sorted by id (reference get_olive_classes.py)."""
    with open(json_path) as f:
        data = json.load(f)
    return [c["name"] for c in sorted(data["categories"],
                                      key=lambda x: x["id"])]


def make_custom_dataset(annotation_file, output_folder, selection,
                        img_src_dir=None):
    """Build a small custom reference/target dataset from a COCO json
    (reference scripts/make_custom_dataset.py): `selection` maps class names
    to reference image ids plus a list of target image ids; produces
    references.json / targets.json + a memory pkl."""
    from no_time_to_train_tpu_torch.data.coco_api import COCO
    coco = COCO(annotation_file)
    name_to_id = {c["name"]: c["id"] for c in coco.dataset["categories"]}

    os.makedirs(os.path.join(output_folder, "images"), exist_ok=True)
    os.makedirs(os.path.join(output_folder, "annotations"), exist_ok=True)

    ref_imgs, ref_anns, cats, memory = [], [], [], OrderedDict()
    for name, img_ids in selection["reference"].items():
        cat_id = name_to_id[name]
        cats.append({"id": cat_id, "name": name})
        memory[cat_id] = []
        for img_id in img_ids:
            info = coco.loadImgs([img_id])[0]
            ref_imgs.append(info)
            for ann in coco.imgToAnns[img_id]:
                if ann["category_id"] == cat_id:
                    ref_anns.append(ann)
                    memory[cat_id].append({"img_id": img_id,
                                           "ann_ids": [ann["id"]]})
                    break
            if img_src_dir:
                src = os.path.join(img_src_dir, info["file_name"])
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(output_folder, "images",
                                                  info["file_name"]))

    tgt_imgs = [coco.loadImgs([i])[0] for i in selection["targets"]]
    tgt_anns = [a for i in selection["targets"] for a in coco.imgToAnns[i]
                if a["category_id"] in {c["id"] for c in cats}]

    refs = {"images": ref_imgs, "annotations": ref_anns, "categories": cats}
    tgts = {"images": tgt_imgs, "annotations": tgt_anns, "categories": cats}
    ann_dir = os.path.join(output_folder, "annotations")
    with open(os.path.join(ann_dir, "references.json"), "w") as f:
        json.dump(refs, f)
    with open(os.path.join(ann_dir, "targets.json"), "w") as f:
        json.dump(tgts, f)
    with open(os.path.join(ann_dir, "memory.pkl"), "wb") as f:
        pickle.dump(memory, f)
    return refs, tgts, memory


def rename_files_sequential(img_dir, json_path, out_json, prefix=""):
    """Rename image files to sequential names and rewrite the json
    (reference rename_olive_files.py / change_filename_pascal.py)."""
    with open(json_path) as f:
        data = json.load(f)
    for i, img in enumerate(sorted(data["images"], key=lambda x: x["id"])):
        ext = os.path.splitext(img["file_name"])[1] or ".jpg"
        new_name = f"{prefix}{i:06d}{ext}"
        src = os.path.join(img_dir, img["file_name"])
        if os.path.exists(src):
            os.rename(src, os.path.join(img_dir, new_name))
        img["file_name"] = new_name
    with open(out_json, "w") as f:
        json.dump(data, f)
    return data


def merge_coco_datasets(json_paths, out_json):
    """Merge several COCO jsons with id re-mapping (reference
    scripts/merge_olive_datasets.py)."""
    merged = {"images": [], "annotations": [], "categories": None}
    next_img, next_ann = 1, 1
    for p in json_paths:
        with open(p) as f:
            d = json.load(f)
        if merged["categories"] is None:
            merged["categories"] = d["categories"]
        remap = {}
        for img in d["images"]:
            remap[img["id"]] = next_img
            img = dict(img, id=next_img)
            merged["images"].append(img)
            next_img += 1
        for ann in d["annotations"]:
            ann = dict(ann, id=next_ann, image_id=remap[ann["image_id"]])
            merged["annotations"].append(ann)
            next_ann += 1
    with open(out_json, "w") as f:
        json.dump(merged, f)
    return merged


def sample_memory_semantic_ref(json_path, out_path, memory_length,
                               class_split=None, seed=0):
    """Semantic-reference sampling: all annotations of a class in one image
    form one reference entry (reference sample_memory_semantic_ref.py)."""
    import random
    from no_time_to_train_tpu_torch.data.coco_api import COCO
    from no_time_to_train_tpu_torch.data.metainfo import METAINFO
    rng = random.Random(seed)
    coco = COCO(json_path)
    names = METAINFO[class_split] if class_split else \
        [c["name"] for c in coco.dataset["categories"]]
    cat_ids = coco.getCatIds(catNms=names)
    out = OrderedDict()
    for cat_id in cat_ids:
        by_img = {}
        for ann in coco.dataset["annotations"]:
            if ann["category_id"] == cat_id:
                by_img.setdefault(ann["image_id"], []).append(ann["id"])
        items = [{"img_id": i, "ann_ids": ids} for i, ids in by_img.items()]
        rng.shuffle(items)
        if len(items) < memory_length:
            raise ValueError(f"class {cat_id}: only {len(items)} images")
        out[cat_id] = items[:memory_length]
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return out
