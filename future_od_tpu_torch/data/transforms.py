"""Box-aware joint video transforms (port of future_od_tpu/data/transforms.py).

Images are (L, H, W, 3) float32 normalized frames, or uint8 frames under
`device_normalize`; boxes are (N, 4) xyxy pixels. The random transforms draw
from Python's `random` and from `np.random` exactly as the JAX package's do,
so one seed gives the same crops and flips in both packages. The resize is
cv2's INTER_LINEAR without OpenCV (`data/image.py::resize_linear`).
"""
from __future__ import annotations

import random
from abc import ABC, abstractmethod
from typing import Sequence, Tuple

import numpy as np

from future_od_tpu_torch.data.image import normalize, resize_linear

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def remap_and_normalize(images_u8: np.ndarray) -> np.ndarray:
    """uint8 (L, H, W, 3) RGB -> float32 normalized with the ImageNet
    statistics: (x / 255 - mean) / std, in one pass of host C++
    (`data/image.py::normalize`), equal to numpy's float32 arithmetic."""
    return normalize(images_u8, IMAGENET_MEAN, IMAGENET_STD)


class JointTransform(ABC):
    @abstractmethod
    def __call__(self, images: np.ndarray, boxes: np.ndarray,
                 classes: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        ...


class JointCompose:
    def __init__(self, transforms: Sequence[JointTransform]):
        self.transforms = list(transforms)

    def __call__(self, images, boxes, classes):
        for t in self.transforms:
            images, boxes, classes = t(images, boxes, classes)
        return images, boxes, classes


class JointNoOpTransform(JointTransform):
    def __call__(self, images, boxes, classes):
        return images, boxes, classes


class JointResize(JointTransform):
    """Bilinear resize of every frame to `size` (H, W), with the boxes
    scaled."""

    def __init__(self, size: Tuple[int, int]):
        self._size = tuple(size)

    def __call__(self, images, boxes, classes):
        old_h, old_w = images.shape[1:3]
        new_h, new_w = self._size
        out = np.stack([resize_linear(frame, (new_h, new_w)) for frame in images])
        scale = np.array(
            [new_w / old_w, new_h / old_h, new_w / old_w, new_h / old_h],
            boxes.dtype if boxes.dtype.kind == "f" else np.float32,
        )
        return out, boxes * scale, classes


class BaseCrop(JointTransform, ABC):
    """Crop with box bookkeeping: shift, drop the objects wholly outside,
    clamp."""

    @abstractmethod
    def _get_crop_param(self, image_h: int, image_w: int) -> Tuple[int, int, int, int]:
        ...

    def __call__(self, images, boxes, classes):
        image_h, image_w = images.shape[1:3]
        i, j, crop_h, crop_w = self._get_crop_param(image_h, image_w)
        images = images[:, i : i + crop_h, j : j + crop_w]
        boxes = boxes - np.array([j, i, j, i], np.float32)
        keep = ((boxes[:, 0] <= crop_w) & (boxes[:, 1] <= crop_h)
                & (boxes[:, 2] >= 0) & (boxes[:, 3] >= 0))
        boxes, classes = boxes[keep], classes[keep]
        boxes[:, 0::2] = boxes[:, 0::2].clip(0, crop_w)
        boxes[:, 1::2] = boxes[:, 1::2].clip(0, crop_h)
        return images, boxes, classes


class JointCenterCrop(BaseCrop):
    def __init__(self, size: Tuple[int, int]):
        self.th, self.tw = size

    def _get_crop_param(self, image_h, image_w):
        return (image_h - self.th) // 2, (image_w - self.tw) // 2, self.th, self.tw


class JointRandomCrop(JointCenterCrop):
    def _get_crop_param(self, image_h, image_w):
        i = random.randint(0, image_h - self.th)
        j = random.randint(0, image_w - self.tw)
        return i, j, self.th, self.tw


class RandomSizedCrop(BaseCrop):
    def __init__(self, min_scale: float, max_scale: float):
        assert max_scale <= 1.0, "Cannot crop more than the whole image!"
        self._min_scale = min_scale
        self._max_scale = max_scale

    def _get_crop_param(self, image_h, image_w):
        scale = random.uniform(self._min_scale, self._max_scale)
        crop_h, crop_w = int(image_h * scale), int(image_w * scale)
        i = random.randint(0, image_h - crop_h)
        j = random.randint(0, image_w - crop_w)
        return i, j, crop_h, crop_w


class CenterBiasedRandomSizedCrop(RandomSizedCrop):
    def _get_crop_param(self, image_h, image_w):
        scale = random.uniform(self._min_scale, self._max_scale)
        crop_h, crop_w = int(image_h * scale), int(image_w * scale)
        max_i, max_j = image_h - crop_h + 1, image_w - crop_w + 1
        i = int(np.random.triangular(0, max_i / 2, max_i))
        j = int(np.random.triangular(0, max_j / 2, max_j))
        return min(i, max_i - 1), min(j, max_j - 1), crop_h, crop_w


class JointHorizontalFlip(JointTransform):
    def __init__(self, p: float = 0.5):
        self._p = p

    def __call__(self, images, boxes, classes):
        if random.random() < self._p:
            images = images[:, :, ::-1].copy()
            w = images.shape[2]
            boxes = boxes[:, [2, 1, 0, 3]] * np.array([-1, 1, -1, 1]) + np.array([w, 0, w, 0])
        return images, boxes, classes


class RandomSelect:
    """transforms1 with probability p, else transforms2."""

    def __init__(self, transforms1, transforms2, p: float = 0.5):
        self.transforms1 = transforms1
        self.transforms2 = transforms2
        self.p = p

    def __call__(self, *args, **kwargs):
        if random.random() < self.p:
            return self.transforms1(*args, **kwargs)
        return self.transforms2(*args, **kwargs)


class SizeFilter(JointTransform):
    """Drop the objects smaller than min_size x the image area."""

    def __init__(self, min_size: float):
        self.min_size = min_size

    def __call__(self, images, boxes, classes):
        image_h, image_w = images.shape[1:3]
        sizes = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep = sizes / (image_h * image_w) > self.min_size
        return images, boxes[keep], classes[keep]
