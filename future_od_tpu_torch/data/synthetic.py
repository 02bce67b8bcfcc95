"""Synthetic moving-box clips (port of future_od_tpu/data/synthetic.py).

Stands in for nuScenes/nuImages when no data is mounted: rectangles moving
at constant velocity over noise, annotated on the last frame, which shows
background only, so the model must extrapolate the motion. Sample `idx` of a
dataset seeded `seed` draws from numpy's default_rng(seed * 1_000_003 + idx),
as the JAX dataset does, so both give the same arrays bit for bit.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

from future_od_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from future_od_tpu_torch.ops.target_utils import construct_box_targets

CATEGORY_DICT = {0: "Vehicle", 1: "Pedestrian"}


class SyntheticClipDataset:
    """The datasets' __getitem__ contract: the batch dict of one clip."""

    def __init__(
        self,
        num_samples: int = 256,
        num_frames: int = 3,
        image_size: Tuple[int, int] = (128, 192),
        max_objects: int = 6,
        max_num_objects: int = 256,
        num_classes: int = 2,
        temporal_offsets: Sequence[float] = (-1.0, -0.5, 0.0),
        seed: int = 0,
    ):
        self.num_samples = num_samples
        self.num_frames = num_frames
        self.image_size = image_size
        self.max_objects = max_objects
        self.max_num_objects = max_num_objects
        self.num_classes = num_classes
        self.temporal_offsets = np.asarray(temporal_offsets, np.float32)
        self.seed = seed

    def __len__(self):
        return self.num_samples

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 1_000_003 + idx)
        H, W = self.image_size
        L = self.num_frames
        n_obj = int(rng.integers(1, self.max_objects + 1))

        video = rng.normal(0.5, 0.08, size=(L, H, W, 3)).astype(np.float32)
        # object state at the final (annotated) frame + constant velocity
        sizes = rng.uniform(10, 36, size=(n_obj, 2)).astype(np.float32)
        centers = rng.uniform([20, 20], [W - 20, H - 20], size=(n_obj, 2)).astype(np.float32)
        vel = rng.uniform(-12, 12, size=(n_obj, 2)).astype(np.float32)  # px / frame
        classes = rng.integers(0, self.num_classes, size=n_obj)
        colors = rng.uniform(0.0, 1.0, size=(n_obj, 3)).astype(np.float32)
        # the class sets the colour's red channel, so the detector can classify
        colors[:, 0] = np.where(classes == 0, 0.9, 0.1)

        boxes_per_frame = []
        for l in range(L):
            dt = l - (L - 1)  # 0 at the annotated (last) frame
            c = centers + vel * dt
            x1 = c[:, 0] - sizes[:, 0] / 2
            y1 = c[:, 1] - sizes[:, 1] / 2
            x2 = c[:, 0] + sizes[:, 0] / 2
            y2 = c[:, 1] + sizes[:, 1] / 2
            boxes_per_frame.append(np.stack([x1, y1, x2, y2], axis=1))
            # the future (annotated) frame shows background only, except in
            # the single-frame case, which is plain detection
            if l < L - 1 or L == 1:
                for o in range(n_obj):
                    xi1, yi1 = max(int(x1[o]), 0), max(int(y1[o]), 0)
                    xi2, yi2 = min(int(x2[o]), W), min(int(y2[o]), H)
                    if xi2 > xi1 and yi2 > yi1:
                        video[l, yi1:yi2, xi1:xi2] = colors[o]

        video = (video - IMAGENET_MEAN) / IMAGENET_STD
        anno_boxes = boxes_per_frame[-1]
        keep = (
            (anno_boxes[:, 2] > 0) & (anno_boxes[:, 0] < W)
            & (anno_boxes[:, 3] > 0) & (anno_boxes[:, 1] < H)
        )
        anno_boxes = anno_boxes[keep].clip([0, 0, 0, 0], [W, H, W, H])
        anno_classes = classes[keep]
        boxes, cls, ignores, active = construct_box_targets(
            anno_boxes, anno_classes, self.max_num_objects
        )

        # IMU: the ego pretends to compensate the objects' motion (a useful
        # conditioning signal): translation = -mean velocity ramp
        mean_vel = vel.mean(axis=0) if n_obj else np.zeros(2, np.float32)
        translation = np.stack([
            np.array([-mean_vel[0] * (l - (L - 1)), -mean_vel[1] * (l - (L - 1)), 0.0],
                     np.float32)
            for l in range(L)
        ])
        zeros3 = np.zeros((L, 3), np.float32)
        rotation = np.tile(np.array([1, 0, 0, 0], np.float32), (L, 1))

        return {
            "video": video.astype(np.float32),
            "boxes": boxes,
            "classes": cls,
            "active": active,
            "annotated_frame_idx": np.int64(L - 1),
            "ignore_boxes": ignores,
            "weather": "none",
            "sun_elevation": -1.0,
            "translation": translation,
            "acceleration": zeros3,
            "rotation": rotation,
            "rotation_rate": zeros3,
            "speed": np.full((L, 1), float(np.linalg.norm(mean_vel)), np.float32),
            "temporal_offsets": self.temporal_offsets[:L].copy(),
            "idf": f"{idx}",
        }
