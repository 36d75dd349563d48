"""Split manifests: filename lists, scene grouping, pairing logic.

Counterpart of mmde_tpu/data/manifests.py, with the same functions and the
same draws from the generator (so both packages pair the same frames).
Covers the reference's manifest handling:
  * `img_path gt_path` list files (dataset/filenames/*, read at
    base_dataset.py:38-42);
  * NYU scene-grouped split with the 27 hard-coded held-out scenes
    (base_dataset_v2.py:27-63);
  * train/test pairing: random frame2 = frame1 + U{1..8} per scene (train),
    consecutive frames (test) (nyudepthv2_v2.py:71-112);
  * VOID release-layout scene/order indexing (void_dataset_v3.py:306-321).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# NYU scenes held out for the paired-frame split (base_dataset_v2.py:31-42)
NYU_TEST_SCENES = frozenset([
    "bathroom_0019", "bathroom_0035", "bathroom_0054",
    "bedroom_0020", "bedroom_0045", "bedroom_0056a", "bedroom_0059",
    "bedroom_0082", "bedroom_0118", "bedroom_0125b",
    "bookstore_0001i", "classroom_0011", "dining_room_0007",
    "dining_room_0024", "furniture_store_0001c", "home_office_0011",
    "kitchen_0011a", "kitchen_0037", "kitchen_0059",
    "living_room_0019", "living_room_0029", "living_room_0046b",
    "living_room_0055", "living_room_0082", "office_0012",
    "office_0024", "reception_room_0001b",
])


def read_list(path: str) -> List[str]:
    with open(path, "r") as f:
        return [line.strip() for line in f if line.strip()]


def read_pair_list(path: str) -> List[Tuple[str, str]]:
    """Lines of `img_path gt_path`."""
    out = []
    for line in read_list(path):
        parts = line.split(" ")
        out.append((parts[0], parts[1]))
    return out


def group_by_scene(pairs: Sequence[Tuple[str, str]], is_train: bool
                   ) -> Dict[str, Dict[str, List[str]]]:
    """Split img/gt paths by scene folder, keeping train or held-out scenes."""
    scenes: Dict[str, Dict[str, List[str]]] = {}
    for img, gt in pairs:
        scene = img.split("/")[-2]
        keep = (scene not in NYU_TEST_SCENES) if is_train \
            else (scene in NYU_TEST_SCENES)
        if not keep:
            continue
        d = scenes.setdefault(scene, {"img": [], "gt": []})
        d["img"].append(img)
        d["gt"].append(gt)
    return scenes


@dataclass(frozen=True)
class FramePair:
    frame1: str
    frame2: str
    gt1: str
    gt2: str


def make_frame_pairs(scenes: Dict[str, Dict[str, List[str]]], is_train: bool,
                     rng: Optional[np.random.Generator] = None,
                     max_idx_diff: int = 8) -> List[FramePair]:
    """Pair frames within a scene: train pairs frame1 with a random later
    frame (offset 1..8), test pairs consecutive frames
    (nyudepthv2_v2.py:71-112)."""
    rng = rng or np.random.default_rng(0)
    out: List[FramePair] = []
    for scene in sorted(scenes):
        imgs = sorted(scenes[scene]["img"])
        gts = sorted(scenes[scene]["gt"])
        n = len(imgs)
        if n < 2:
            continue
        if is_train:
            order = rng.permutation(n - 1)
            for i in order:
                spare = n - 1 - int(i)
                diff = int(rng.integers(1, min(spare, max_idx_diff) + 1))
                j = int(i) + diff
                out.append(FramePair(imgs[i], imgs[j], gts[i], gts[j]))
        else:
            for i in range(n - 1):
                out.append(FramePair(imgs[i], imgs[i + 1], gts[i], gts[i + 1]))
    return out


@dataclass(frozen=True)
class VoidSample:
    """One VOID v3 index entry: a scene + frame order (void_dataset_v3.py:306-321)."""
    scene: str
    order: int
    file_name: str


def index_void_release(release_dir: str, list_file: str,
                       max_interval: int) -> List[VoidSample]:
    """Build the sample index from the official VOID image list: keep frames
    whose pair partner (order + max_interval) stays in range."""
    samples: List[VoidSample] = []
    scene_images: Dict[str, List[str]] = {}
    for file_path in read_list(list_file):
        file_name = os.path.basename(file_path)
        # path shape .../data/<scene>/image/<stamp>.png
        scene = file_path[file_path.rfind("/data/") + 6:
                          file_path.rfind("/image/")]
        if scene not in scene_images:
            img_dir = os.path.join(release_dir, scene, "image")
            scene_images[scene] = sorted(os.listdir(img_dir))
        imgs = scene_images[scene]
        order = imgs.index(file_name)
        if order + max_interval < len(imgs):
            samples.append(VoidSample(scene, order, file_name))
    return samples
