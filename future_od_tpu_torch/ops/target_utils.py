"""The DETR target format (port of future_od_tpu/ops/target_utils.py::
to_detr_targets). Targets stay in the batch's dense (B, Nmax) slot layout
with an active mask, which the matcher and the set criterion consume."""
from __future__ import annotations

from typing import Dict

import torch


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
