"""Dense targets and the DETR target format (port of
future_od_tpu/ops/target_utils.py). Targets stay in the batch's dense
(B, Nmax) slot layout with an active mask, which the matcher and the set
criterion consume."""
from __future__ import annotations

from typing import Dict, Optional, Set, Tuple

import numpy as np
import torch


def construct_box_targets(
    boxes: np.ndarray, classes: np.ndarray, max_num_objects: int,
    ignore_categories: Optional[Set[int]] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-side padding of one image's annotations to Nmax dense slots:
    boxes (N, 4) xyxy pixels, classes (N,) -> boxes (Nmax, 4) f32, classes
    (Nmax,) int64, ignore_boxes (Nmax, 4) f32, active (Nmax,) int64. Objects
    of an ignore category go to ignore_boxes."""
    boxes = np.asarray(boxes, dtype=np.float32).reshape(-1, 4)
    classes = np.asarray(classes, dtype=np.int64).reshape(-1)
    if ignore_categories:
        ignore_mask = np.isin(classes, list(ignore_categories))
    else:
        ignore_mask = np.zeros_like(classes, dtype=bool)
    obj_boxes = boxes[~ignore_mask][:max_num_objects]
    obj_classes = classes[~ignore_mask][:max_num_objects]
    ign_boxes = boxes[ignore_mask][:max_num_objects]

    out_boxes = np.zeros((max_num_objects, 4), dtype=np.float32)
    out_ignores = np.zeros((max_num_objects, 4), dtype=np.float32)
    out_classes = np.zeros((max_num_objects,), dtype=np.int64)
    out_active = np.zeros((max_num_objects,), dtype=np.int64)
    out_boxes[: len(obj_boxes)] = obj_boxes
    out_ignores[: len(ign_boxes)] = ign_boxes
    out_classes[: len(obj_classes)] = obj_classes
    out_active[: len(obj_classes)] = 1
    return out_boxes, out_classes, out_ignores, out_active


def to_detr_targets(height: int, width: int, anno_active, anno_boxes,
                    anno_classes) -> Dict[str, torch.Tensor]:
    """xyxy pixel boxes -> {"boxes": (B, Nmax, 4) normalized cxcywh,
    "labels": (B, Nmax) int32, "active": (B, Nmax) bool}. Inactive slots
    keep their (zero) boxes and labels; every consumer masks them."""
    cxcywh = torch.cat(
        [0.5 * (anno_boxes[..., 0:2] + anno_boxes[..., 2:4]),
         anno_boxes[..., 2:4] - anno_boxes[..., 0:2]],
        dim=-1,
    )
    scale = torch.tensor([1.0 / width, 1.0 / height, 1.0 / width, 1.0 / height],
                         dtype=cxcywh.dtype, device=cxcywh.device)
    return {
        "boxes": cxcywh * scale,
        "labels": anno_classes.to(torch.int32),
        "active": anno_active.to(torch.bool),
    }
