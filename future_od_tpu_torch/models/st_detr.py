"""SpatioTemporalDETR task wrapper, loss and post-processing (port of
future_od_tpu/models/st_detr.py).

`SpatioTemporalDETRArgs` is this package's own copy of the JAX dataclass
(the port imports nothing of the JAX package), so one args object describes
a model for both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn

from future_od_tpu_torch.models.set_criterion import CriterionConfig, set_criterion, weighted_total
from future_od_tpu_torch.ops.misc import video_hw
from future_od_tpu_torch.ops.target_utils import to_detr_targets

IMU_KEYS = ("translation", "acceleration", "rotation", "rotation_rate")
# per-frame widths of the IMU keys (rotation is a quaternion)
IMU_WIDTHS = {"translation": 3, "acceleration": 3, "rotation": 4, "rotation_rate": 3, "speed": 1}


@dataclass(frozen=True)
class SpatioTemporalDETRArgs:
    """All model/loss hyperparameters (copy of the JAX package's)."""

    num_classes: int
    masks: bool = False

    # Optimization
    lr_backbone: float = 1e-5
    lr: float = 1e-4
    weight_decay: float = 1e-4
    max_norm: float = 0.1

    # Backbone
    backbone: str = "resnet50"
    dilation: bool = False
    position_embedding: str = "sine"
    pretrained_backbone: bool = True

    # Transformer settings
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    hidden_dim: int = 256
    dropout: float = 0.1
    enc_nheads: int = 8
    nheads: int = 8
    num_queries: int = 300
    pre_norm: bool = False

    # Matcher settings
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0

    # Loss settings
    aux_loss: bool = True
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    focal_alpha: float = 0.25

    # Data settings
    no_imu_speed: bool = False
    encode_offset: bool = False

    # Extras of the JAX package
    matcher: str = "auction"
    cost_slots: int = 128
    space_to_depth: bool = False
    int8_backbone: bool = False
    int8_static: bool = False
    freeze_stem: bool = True

    def criterion_config(self, matching_mode: str = "per level") -> CriterionConfig:
        return CriterionConfig(
            num_classes=self.num_classes,
            cls_loss_coef=self.cls_loss_coef,
            bbox_loss_coef=self.bbox_loss_coef,
            giou_loss_coef=self.giou_loss_coef,
            focal_alpha=self.focal_alpha,
            set_cost_class=self.set_cost_class,
            set_cost_bbox=self.set_cost_bbox,
            set_cost_giou=self.set_cost_giou,
            matching_mode=matching_mode,
            matcher=self.matcher,
            aux_loss=self.aux_loss,
            masks=self.masks,
            cost_slots=self.cost_slots,
        )

    def imu_keys(self) -> Tuple[str, ...]:
        return IMU_KEYS + (() if self.no_imu_speed else ("speed",))

    def imu_dim(self) -> int:
        return sum(IMU_WIDTHS[k] for k in self.imu_keys())


STAT_IDFS = (
    "labels", "box_l1", "box_giou", "cardinality", "class_error",
    "matcher_rounds", "matcher_unmatched", "matcher_dropped",
)


class SpatioTemporalDETR(nn.Module):
    """Assembles the IMU input (and, under `encode_offset`, the temporal
    offsets) from the batch and runs the core (`_model`, the reference
    checkpoint's prefix). Each forward first drops the attention weights an
    earlier one captured (`captured_attention`), as each JAX apply starts
    a fresh `intermediates` collection."""

    def __init__(self, core: nn.Module, args: SpatioTemporalDETRArgs):
        super().__init__()
        self._model = core
        self.args = args
        self._capturing = tuple(module for _, module in capturing_modules(core))

    def forward(self, data: Dict[str, torch.Tensor], aux_levels: bool = False):
        """aux_levels: the detector's aux levels in eval mode too (the eval
        step's loss; training always returns them with `aux_loss`)."""
        for module in self._capturing:
            module.captured.clear()
        imu = None
        if data.get("translation") is not None:
            imu = torch.cat([data[k] for k in self.args.imu_keys()], dim=2)
        offsets = data["temporal_offsets"] if self.args.encode_offset else None
        return self._model(data["video"], imu, offsets, aux_levels)


def capturing_modules(model: nn.Module):
    """(JAX intermediates path, module) of every attention that captures
    its weights (`store_attention`): the port's module name with `_model`
    as `core`, `layers.{i}` as `layer{i}` and `image_attend.{j}` as
    `image_attend{j}`, joined by `/`."""
    for name, module in model.named_modules():
        if getattr(module, "store_attention", False):
            path = []
            for part in name.split("."):
                if part.isdigit():
                    path[-1] = ("layer" if path[-1] == "layers" else path[-1]) + part
                else:
                    path.append("core" if part == "_model" else part)
            yield "/".join(path), module


def captured_attention(model: nn.Module) -> Dict[str, Tuple[torch.Tensor, ...]]:
    """The head-averaged attention weights (B, Nq, Nk) the last forward
    captured, one per call in call order, keyed by the JAX intermediates
    path of the capturing module (e.g. `core/detector/decoder/layer0/
    image_attend1`): what `model.apply(..., mutable=["intermediates"])`
    gives under `<path>/attention_weights`."""
    return {path: tuple(module.captured) for path, module in capturing_modules(model)
            if module.captured}


def normalize_outputs(outputs, data: Optional[Dict[str, torch.Tensor]] = None):
    """(annotated-frame output, pred_logits, pred_boxes) from a core's
    output; logits/boxes gain the L_out axis at dim 1. A single-frame dict
    passes through as the annotated output (with its `aux_outputs`, in
    training); a list of per-frame dicts is stacked, and each batch
    element's annotated frame (`data["annotated_frame_idx"]`) is gathered,
    its aux levels too."""
    if isinstance(outputs, (list, tuple)):
        pred_logits = torch.stack([o["pred_logits"] for o in outputs], dim=1)
        pred_boxes = torch.stack([o["pred_boxes"] for o in outputs], dim=1)
        rows = torch.arange(pred_logits.shape[0], device=pred_logits.device)
        idx = data["annotated_frame_idx"].to(pred_logits.device).long()

        def take(key, levels: List[Dict[str, torch.Tensor]]):
            return torch.stack([o[key] for o in levels], dim=1)[rows, idx]

        annotated = {"pred_logits": pred_logits[rows, idx], "pred_boxes": pred_boxes[rows, idx]}
        num_aux = len(outputs[0].get("aux_outputs", []))
        if num_aux:
            annotated["aux_outputs"] = [
                {key: take(key, [o["aux_outputs"][a] for o in outputs])
                 for key in ("pred_logits", "pred_boxes")}
                for a in range(num_aux)
            ]
        return annotated, pred_logits, pred_boxes
    if outputs["pred_logits"].ndim != 3:
        raise ValueError(f"cannot interpret output of shape {tuple(outputs['pred_logits'].shape)}")
    return outputs, outputs["pred_logits"][:, None], outputs["pred_boxes"][:, None]


def compute_loss(annotated_output: Dict[str, Any], data: Dict[str, torch.Tensor],
                 criterion_cfg: CriterionConfig, pred_idx_all: Optional[torch.Tensor] = None,
                 num_boxes: Optional[torch.Tensor] = None):
    """(weighted total loss, the stats named by STAT_IDFS) of an annotated
    output against the batch's dense xyxy pixel targets."""
    H, W = video_hw(data["video"])
    targets = to_detr_targets(H, W, data["active"], data["boxes"], data["classes"])
    if criterion_cfg.masks:
        # mask targets do not follow from the boxes: the batch carries them
        if "masks" not in data:
            raise ValueError(
                "criterion_cfg.masks=True requires dense mask targets in the batch: "
                "data['masks'] with shape (B, N, H, W) aligned to the boxes/classes slots "
                "(no bundled dataset emits them)")
        targets = {**targets, "masks": data["masks"]}
    losses = set_criterion(annotated_output, targets, criterion_cfg, pred_idx_all, num_boxes)
    num_aux = len(annotated_output.get("aux_outputs", []))
    total, weights = weighted_total(losses, criterion_cfg, num_aux)
    stats = {
        "labels": losses["loss_ce"] * weights["loss_ce"],
        "box_l1": losses["loss_bbox"] * weights["loss_bbox"],
        "box_giou": losses["loss_giou"] * weights["loss_giou"],
        "cardinality": losses["cardinality_error"],
        "class_error": losses["class_error"],
        "matcher_rounds": losses["matcher_rounds"],
        "matcher_unmatched": losses["matcher_unmatched"],
        "matcher_dropped": losses["matcher_dropped"],
    }
    return total, stats


def post_process(pred_logits, pred_boxes, data):
    """Sigmoid scores + generic-object class + pixel xyxy boxes.
    pred_logits (B, L_out, M, C), pred_boxes (B, L_out, M, 4) cxcywh in
    [0, 1]. Returns (output dict, the annotated frame's scores, its boxes):
    with one output a frame of a multi-frame clip, the annotated frame is
    each clip's `annotated_frame_idx`, else the first output."""
    H, W = video_hw(data["video"])
    scores = torch.sigmoid(pred_logits)
    scores = torch.cat([scores, scores.amax(dim=3, keepdim=True)], dim=3)
    boxes = pred_boxes * torch.tensor(
        [W, H, W, H], dtype=pred_boxes.dtype, device=pred_boxes.device
    )
    boxes = torch.cat(
        [boxes[..., 0:2] - 0.5 * boxes[..., 2:4], boxes[..., 0:2] + 0.5 * boxes[..., 2:4]],
        dim=-1,
    )
    output = {
        "class_scores": scores[:, :, None],  # (B, L_out, 1, M, C+1)
        "boxes": boxes[:, :, None],
    }
    if boxes.shape[1] == data["video"].shape[1] > 1:
        rows = torch.arange(boxes.shape[0], device=boxes.device)
        idx = data["annotated_frame_idx"].to(boxes.device).long()
        return output, scores[rows, idx], boxes[rows, idx]
    return output, scores[:, 0], boxes[:, 0]
