"""Bounding-box visualization (port of future_od_tpu/utils/visualization.py).

Host-side numpy: undo the ImageNet normalization, draw prediction or
annotation boxes in the reference's 125-colour cube, and write a PNG with
the standard library's zlib (no OpenCV or PIL). W&B images when wandb is
installed.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Optional

import numpy as np

from future_od_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from future_od_tpu_torch.utils.wandb import maybe_import_wandb

# 5x5x5 RGB colour cube (visualization.py:9-16).
_v = np.array([0.0, 0.25, 0.5, 0.75, 1.0], np.float32)
COLOURS = np.stack(np.meshgrid(_v, _v, _v, indexing="ij"), axis=-1).reshape(-1, 3)[:, ::-1]


def revert_imagenet_normalization(image: np.ndarray) -> np.ndarray:
    """(H, W, 3) normalized -> [0, 1] RGB float32. A uint8 image (a batch
    normalized on the device) is only rescaled, so callers must not cast it
    to float first."""
    image = np.asarray(image)
    if image.dtype == np.uint8:
        return image.astype(np.float32) / 255.0
    return image.astype(np.float32) * IMAGENET_STD + IMAGENET_MEAN


def draw_boxes(image: np.ndarray, boxes: np.ndarray, colours: np.ndarray, thickness=3):
    """Draw box outlines in place; image (H, W, 3) float [0, 1], boxes (N, 4)
    xyxy pixels (visualization.py:32-44)."""
    H, W = image.shape[:2]
    for n in range(len(boxes)):
        x1 = int(np.clip(boxes[n, 0], thickness, W - thickness))
        y1 = int(np.clip(boxes[n, 1], thickness, H - thickness))
        x2 = int(np.clip(boxes[n, 2], thickness, W - thickness))
        y2 = int(np.clip(boxes[n, 3], thickness, H - thickness))
        c = colours[n]
        image[y1 - thickness : y2, x1 - thickness : x1] = c
        image[y2 : y2 + thickness, x1 - thickness : x2] = c
        image[y1 : y2 + thickness, x2 : x2 + thickness] = c
        image[y1 - thickness : y1, x1 : x2 + thickness] = c
    return image


def write_png(fpath: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as an 8-bit truecolour PNG,
    deflated at level 1 with run-length matching, OpenCV's default for PNG
    (the Trainer writes a batch of full-size frames on the host between two
    steps)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    H, W, _ = rgb.shape
    rows = np.concatenate([np.zeros((H, 1), np.uint8), rgb.reshape(H, 3 * W)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit RGB, no interlace
    deflate = zlib.compressobj(1, zlib.DEFLATED, 15, 9, zlib.Z_RLE)
    data = deflate.compress(rows.tobytes()) + deflate.flush()
    with open(fpath, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header) + chunk(b"IDAT", data)
                + chunk(b"IEND", b""))


def visualize(
    image: np.ndarray,
    classes: Optional[np.ndarray],
    boxes: Optional[np.ndarray],
    fpath: str,
    background_class: int,
    score_threshold: float = 0.5,
) -> np.ndarray:
    """Render one frame with its boxes and write a PNG (visualization.py:47-71).

    classes are int labels (annotations) or float score matrices (M, C)
    (predictions), which are argmaxed and thresholded.
    """
    vis = revert_imagenet_normalization(image)
    if boxes is not None and classes is not None:
        classes = np.asarray(classes)
        boxes = np.asarray(boxes)
        if classes.dtype.kind == "f":
            scores = classes.max(axis=1)
            classes = classes.argmax(axis=1)
            classes = np.where(scores < score_threshold, background_class, classes)
        keep = classes != background_class
        vis = draw_boxes(vis, boxes[keep], COLOURS[classes[keep] % len(COLOURS)])
    os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
    write_png(fpath, (vis.clip(0, 1) * 255).astype(np.uint8))
    return vis


def visualize_wandb(
    image: np.ndarray,
    background_class: int,
    category_dict: Dict[int, str],
    pred_scores: Optional[np.ndarray] = None,
    pred_boxes: Optional[np.ndarray] = None,
    anno_classes: Optional[np.ndarray] = None,
    anno_boxes: Optional[np.ndarray] = None,
    ignore_boxes: Optional[np.ndarray] = None,
    model_mood=None,
    score_threshold: float = 0.1,
):
    """W&B image with prediction, annotation and ignore overlays
    (visualization.py:74-150). None when wandb is not installed."""
    wandb = maybe_import_wandb()
    if wandb is None:
        return None

    H, W = image.shape[:2]
    img = revert_imagenet_normalization(image)
    boxes = {}

    def box_data(bxs, labels, scores=None):
        out = []
        for i in range(len(bxs)):
            d = {
                "position": {
                    "minX": float(bxs[i, 0] / W), "maxX": float(bxs[i, 2] / W),
                    "minY": float(bxs[i, 1] / H), "maxY": float(bxs[i, 3] / H),
                },
                "class_id": int(labels[i]),
            }
            if scores is not None:
                d["scores"] = {"confidence": float(scores[i])}
            out.append(d)
        return out

    class_labels = {int(k): v for k, v in category_dict.items()}
    class_labels[background_class] = "background"
    if pred_boxes is not None and pred_scores is not None:
        scores = pred_scores.max(axis=1)
        labels = pred_scores.argmax(axis=1)
        keep = scores >= score_threshold
        boxes["predictions"] = {
            "box_data": box_data(pred_boxes[keep], labels[keep], scores[keep]),
            "class_labels": class_labels,
        }
    if anno_boxes is not None and anno_classes is not None:
        keep = anno_classes != background_class
        boxes["ground_truth"] = {
            "box_data": box_data(anno_boxes[keep], anno_classes[keep]),
            "class_labels": class_labels,
        }
    if ignore_boxes is not None:
        keep = (ignore_boxes[:, 2] - ignore_boxes[:, 0]) > 0
        boxes["ignore"] = {
            "box_data": box_data(ignore_boxes[keep], np.full(keep.sum(), background_class)),
            "class_labels": class_labels,
        }
    caption = str(model_mood) if model_mood is not None else None
    return wandb.Image((img.clip(0, 1) * 255).astype(np.uint8), boxes=boxes, caption=caption)
