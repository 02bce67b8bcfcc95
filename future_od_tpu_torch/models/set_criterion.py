"""DETR set-prediction criterion (port of future_od_tpu/models/set_criterion.py,
box losses only: the mask losses are not ported yet).

Targets stay in the dense (B, Nmax) slot layout with an active mask. Before
the cost build, active slots are gathered to the front and cut to
`cost_slots` (`compact_targets`); all levels are matched in one batched
solve; loss math runs in f32. `num_boxes` is the batch's active-target count
before compaction, floored at 1.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, elementwise_generalized_box_iou
from future_od_tpu_torch.ops.losses import class_error, sigmoid_focal_loss
from future_od_tpu_torch.ops.matching import SOLVERS, matching_cost


@dataclass(frozen=True)
class CriterionConfig:
    """The JAX package's criterion settings (copy), without the mask losses."""

    num_classes: int
    cls_loss_coef: float = 2.0
    bbox_loss_coef: float = 5.0
    giou_loss_coef: float = 2.0
    focal_alpha: float = 0.25
    set_cost_class: float = 2.0
    set_cost_bbox: float = 5.0
    set_cost_giou: float = 2.0
    matching_mode: str = "per level"  # | "last level"
    matcher: str = "auction"  # | "hungarian"
    aux_loss: bool = True
    masks: bool = False
    # active targets gathered to the front and cut to this many slots before
    # matching (0 disables); overflow is dropped and counted in matcher_dropped
    cost_slots: int = 128

    def __post_init__(self):
        assert self.matching_mode in ("per level", "last level")
        assert self.matcher in SOLVERS
        if self.masks:
            raise NotImplementedError(
                "mask losses are not ported yet (ROADMAP.md Queue 1 item 1e)"
            )


def compact_targets(targets: Dict[str, torch.Tensor],
                    n_cost: int) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """Gather active slots to the front (a stable sort keeps their order) and
    keep n_cost slots. Returns (targets, dropped): dropped counts the active
    targets that did not fit."""
    active = targets["active"]
    B, N = active.shape
    if not n_cost or n_cost >= N:
        return targets, torch.zeros((), dtype=torch.float32, device=active.device)
    order = torch.sort((~active).to(torch.uint8), dim=1, stable=True).indices[:, :n_cost]
    out = {
        "active": torch.gather(active, 1, order),
        "labels": torch.gather(targets["labels"], 1, order),
        "boxes": torch.gather(targets["boxes"], 1, order[..., None].expand(-1, -1, 4)),
    }
    dropped = (active.sum(-1) - n_cost).clamp(min=0).sum().float()
    return out, dropped


def _level_losses(outputs, targets, pred_idx, num_boxes, cfg: CriterionConfig,
                  log: bool) -> Dict[str, torch.Tensor]:
    """Focal, L1 and GIoU losses of one level for the assignment pred_idx
    (B, N) in [0, M] (M: unmatched), plus the cardinality error and, with
    `log`, the class error."""
    logits = outputs["pred_logits"].float()  # (B, M, C)
    boxes = outputs["pred_boxes"].float()
    B, M, C = logits.shape
    matched = targets["active"] & (pred_idx < M)  # (B, N)

    # labels scattered onto their matched queries; unmatched queries keep
    # the background class (num_classes: an all-zero one-hot row)
    scatter_idx = torch.where(matched, pred_idx, M)  # M: a spill column
    labels = torch.where(matched, targets["labels"].long(), cfg.num_classes)
    target_classes = torch.full((B, M + 1), cfg.num_classes, dtype=torch.int64,
                                device=logits.device)
    target_classes = target_classes.scatter(1, scatter_idx, labels)[:, :M]
    onehot = F.one_hot(target_classes, max(C, cfg.num_classes) + 1)[..., :C].to(logits.dtype)
    loss_ce = sigmoid_focal_loss(logits, onehot, num_boxes, alpha=cfg.focal_alpha, gamma=2.0) * M

    gather_idx = pred_idx.clamp(0, M - 1)
    src_boxes = torch.gather(boxes, 1, gather_idx[..., None].expand(-1, -1, 4))  # (B, N, 4)
    l1 = (src_boxes - targets["boxes"]).abs().sum(-1)
    loss_bbox = torch.where(matched, l1, 0.0).sum() / num_boxes
    giou = elementwise_generalized_box_iou(
        box_cxcywh_to_xyxy(src_boxes), box_cxcywh_to_xyxy(targets["boxes"])
    )
    loss_giou = torch.where(matched, 1.0 - giou, 0.0).sum() / num_boxes
    losses = {"loss_ce": loss_ce, "loss_bbox": loss_bbox, "loss_giou": loss_giou}

    with torch.no_grad():
        card_pred = (logits.amax(-1) > 0.5).sum(-1).float()
        tgt_len = targets["active"].sum(-1).float()
        losses["cardinality_error"] = (card_pred - tgt_len).abs().mean()
        if log:
            matched_logits = torch.gather(logits, 1, gather_idx[..., None].expand(-1, -1, C))
            losses["class_error"] = class_error(matched_logits, targets["labels"].long(), matched)
    return losses


def matching_costs_all(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
                       cfg: CriterionConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked costs of every level the criterion matches: ((A·B, M, N)
    costs, (A·B, N) active), A = 1 + the aux levels under "per level"
    matching, else 1. N is cost_slots where compaction applies, so indices
    solved on these costs align with `set_criterion`'s compacted layout."""
    targets, _ = compact_targets(targets, cfg.cost_slots)
    levels = [outputs]
    if cfg.aux_loss and cfg.matching_mode == "per level":
        levels += list(outputs.get("aux_outputs", []))
    costs = torch.cat([
        matching_cost(lvl["pred_logits"], lvl["pred_boxes"], targets,
                      cost_class=cfg.set_cost_class, cost_bbox=cfg.set_cost_bbox,
                      cost_giou=cfg.set_cost_giou, focal_alpha=cfg.focal_alpha)
        for lvl in levels
    ], dim=0)
    return costs, targets["active"].repeat(len(levels), 1)


def set_criterion(outputs: Dict[str, Any], targets: Dict[str, torch.Tensor],
                  cfg: CriterionConfig, pred_idx_all: Optional[torch.Tensor] = None,
                  num_boxes: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
    """Losses of the final level and the aux levels (suffixed `_{i}`), and
    the matcher telemetry. pred_idx_all (A, B, N), when given, replaces the
    solve (A as `matching_costs_all` counts levels, N its slot count)."""
    if num_boxes is None:
        num_boxes = targets["active"].sum().float().clamp(min=1.0)
    targets, dropped = compact_targets(targets, cfg.cost_slots)
    aux = list(outputs.get("aux_outputs", [])) if cfg.aux_loss else []
    B = targets["active"].shape[0]

    if pred_idx_all is not None:
        rounds = torch.zeros((1,), dtype=torch.int32, device=pred_idx_all.device)
        pred_idx = pred_idx_all[0].long()
        aux_idx = ([pred_idx_all[i + 1].long() for i in range(len(aux))]
                   if pred_idx_all.shape[0] > 1 else [pred_idx] * len(aux))
    else:
        # every level in one batched solve: the auction's rounds are the only
        # sequential part, so (levels+1)·B problems run in lockstep
        costs, tiled_active = matching_costs_all(outputs, targets, cfg)
        all_idx, rounds = SOLVERS[cfg.matcher](costs, tiled_active, return_rounds=True)
        all_idx = all_idx.reshape(-1, B, all_idx.shape[-1])
        pred_idx = all_idx[0]
        aux_idx = ([all_idx[i + 1] for i in range(len(aux))] if all_idx.shape[0] > 1
                   else [pred_idx] * len(aux))

    losses = _level_losses(outputs, targets, pred_idx, num_boxes, cfg, log=True)
    for i, lvl in enumerate(aux):
        aux_losses = _level_losses(lvl, targets, aux_idx[i], num_boxes, cfg, log=False)
        losses.update({f"{k}_{i}": v for k, v in aux_losses.items()})

    M = outputs["pred_logits"].shape[1]
    losses["matcher_rounds"] = rounds.max().float()
    losses["matcher_unmatched"] = (targets["active"] & (pred_idx == M)).sum().float() / B
    losses["matcher_dropped"] = dropped
    return losses


def weighted_total(losses: Dict[str, torch.Tensor], cfg: CriterionConfig, num_aux: int):
    """(Σ weight_k · loss_k, the weights): the reference's weight dict."""
    base = {"loss_ce": cfg.cls_loss_coef, "loss_bbox": cfg.bbox_loss_coef,
            "loss_giou": cfg.giou_loss_coef}
    weights = dict(base)
    for i in range(num_aux):
        weights.update({f"{k}_{i}": v for k, v in base.items()})
    total = sum(losses[k] * w for k, w in weights.items() if k in losses)
    return total, weights
