"""Image normalization (the start of a port of future_od_tpu/data/transforms.py:
its ImageNet statistics and `remap_and_normalize`). The box-aware joint
transforms come with the nuScenes/nuImages datasets (ROADMAP.md Queue 1
item 2a)."""
from __future__ import annotations

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def remap_and_normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 (L, H, W, 3) RGB -> float32 normalized with the ImageNet
    statistics."""
    x = images_u8.astype(np.float32) / 255.0
    return (x - IMAGENET_MEAN) / IMAGENET_STD
