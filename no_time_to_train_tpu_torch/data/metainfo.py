"""The port's own copy of `no_time_to_train_tpu/data/metainfo.py`, so that the
port imports nothing of the JAX package.

Class-split registry (reference no_time_to_train/dataset/metainfo.py:234).

The split contents are public dataset constants (COCO-80 names, the 20
few-shot novel classes, 4 semantic splits, PASCAL-VOC unseen splits, LVIS
1203/461/405/337 frequency buckets, olive diseases, and the Bansal et al.
COCO zero-shot 48-seen/17-unseen OVD split — reference
dataset/cd_vito_paper_coco_zeroshot_categories.py), stored as data in
metainfo.json.
"""
import json
from pathlib import Path

with open(Path(__file__).parent / "metainfo.json") as _f:
    METAINFO = {k: tuple(v) for k, v in json.load(_f).items()}
