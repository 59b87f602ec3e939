"""Minimal COCO-JSON reader (pycocotools replacement).

The reference indexes PoseTrack through ``pycocotools.coco.COCO``
(``PoseTrack_Alignment.py:78``), which is unavailable here; this module
implements the small slice of its API the data layer needs: image/annotation/
category indexing with ``getImgIds`` / ``loadImgs`` / ``getAnnIds`` /
``loadAnns`` / ``getCatIds`` / ``loadCats`` semantics.
"""

import json
from collections import defaultdict
from typing import Dict, List, Optional


class COCOJson:
    def __init__(self, annotation_file: str = None, dataset: Optional[dict] = None):
        if dataset is None:
            with open(annotation_file, "r") as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, dict] = {}
        self.anns: Dict[int, dict] = {}
        self.cats: Dict[int, dict] = {}
        self.img_to_anns: Dict[int, List[int]] = defaultdict(list)
        for img in dataset.get("images", []):
            self.imgs[img["id"]] = img
        for i, ann in enumerate(dataset.get("annotations", [])):
            ann_id = ann.get("id", i)
            self.anns[ann_id] = ann
            self.img_to_anns[ann["image_id"]].append(ann_id)
        for cat in dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self) -> List[int]:
        return sorted(self.imgs.keys())

    def loadImgs(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    def getAnnIds(self, imgIds=None, iscrowd: Optional[bool] = None) -> List[int]:
        if imgIds is None:
            ids = list(self.anns.keys())
        else:
            if isinstance(imgIds, int):
                imgIds = [imgIds]
            ids = [a for i in imgIds for a in self.img_to_anns.get(i, [])]
        if iscrowd is not None:
            want = 1 if iscrowd else 0
            ids = [a for a in ids if self.anns[a].get("iscrowd", 0) == want]
        return ids

    def loadAnns(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def getCatIds(self) -> List[int]:
        return sorted(self.cats.keys())

    def loadCats(self, ids) -> List[dict]:
        if isinstance(ids, int):
            ids = [ids]
        return [self.cats[i] for i in ids]
