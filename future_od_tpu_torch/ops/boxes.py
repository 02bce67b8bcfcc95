"""Box coordinate utilities (port of future_od_tpu/ops/boxes.py).

DETR box ops on any (..., 4) tensor: cxcywh <-> xyxy conversion, areas,
pairwise IoU and GIoU, the elementwise GIoU of matched pairs, and the mAP
metric's batched IoU with its 1e-7 epsilons.
"""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2)."""
    cx, cy, w, h = boxes.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    return torch.stack([0.5 * (x1 + x2), 0.5 * (y1 + y2), x2 - x1, y2 - y1], dim=-1)


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    return (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])


def box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor):
    """Pairwise IoU of (..., M, 4) and (..., N, 4) xyxy boxes: (iou, union),
    each (..., M, N)."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1[..., :, None] + area2[..., None, :] - inter
    return inter / union, union


def generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Pairwise GIoU = IoU - (hull - union) / hull -> (..., M, N)."""
    iou, union = box_iou(boxes1, boxes2)
    lt = torch.minimum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.maximum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    area = wh[..., 0] * wh[..., 1]
    return iou - (area - union) / area


def elementwise_generalized_box_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """GIoU of matching rows of two (..., 4) xyxy tensors -> (...): the
    diagonal of `generalized_box_iou` without the M x N matrix."""
    area1, area2 = box_area(boxes1), box_area(boxes2)
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area1 + area2 - inter
    iou = inter / union
    wh_c = (torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
            - torch.minimum(boxes1[..., :2], boxes2[..., :2])).clamp(min=0.0)
    area_c = wh_c[..., 0] * wh_c[..., 1]
    return iou - (area_c - union) / area_c


def batched_box_iou(boxes_one: torch.Tensor, boxes_two: torch.Tensor) -> torch.Tensor:
    """The mAP metric's IoU of (B, M, 4) and (B, N, 4) xyxy boxes -> (B, M, N):
    negative sides clamp to 0, and numerator and denominator each carry
    1e-7, so empty against empty gives 1."""
    b1, b2 = boxes_one[:, :, None, :], boxes_two[:, None, :, :]
    area1 = (b1[..., 2] - b1[..., 0]).relu() * (b1[..., 3] - b1[..., 1]).relu()
    area2 = (b2[..., 2] - b2[..., 0]).relu() * (b2[..., 3] - b2[..., 1]).relu()
    inter = (torch.minimum(b1[..., 2], b2[..., 2]) - torch.maximum(b1[..., 0], b2[..., 0])).relu() \
        * (torch.minimum(b1[..., 3], b2[..., 3]) - torch.maximum(b1[..., 1], b2[..., 1])).relu()
    return (inter + 1e-7) / (area1 + area2 - inter + 1e-7)
