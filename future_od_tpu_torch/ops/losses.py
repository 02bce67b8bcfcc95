"""Loss primitives (port of future_od_tpu/ops/losses.py): the DETR sigmoid
focal loss, the dice loss of masks and the class error of matched
predictions."""
from __future__ import annotations

import torch


def sigmoid_binary_cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable BCE-with-logits, elementwise."""
    return logits.clamp(min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, num_boxes, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """DETR focal loss over (B, M, C) logits and one-hot targets: mean over
    queries, summed over batch and classes, divided by num_boxes."""
    prob = torch.sigmoid(logits)
    ce = sigmoid_binary_cross_entropy(logits, targets)
    p_t = prob * targets + (1.0 - prob) * (1.0 - targets)
    loss = ce * (1.0 - p_t) ** gamma
    if alpha >= 0:
        loss = (alpha * targets + (1.0 - alpha) * (1.0 - targets)) * loss
    return loss.mean(dim=1).sum() / num_boxes


def dice_loss(logits: torch.Tensor, targets: torch.Tensor, num_boxes) -> torch.Tensor:
    """DICE/F-1 loss of (N, HW) flattened mask logits against 0/1 targets,
    summed over the masks and divided by num_boxes."""
    probs = torch.sigmoid(logits)
    numerator = 2.0 * (probs * targets).sum(dim=1)
    denominator = probs.sum(dim=1) + targets.sum(dim=1)
    return (1.0 - (numerator + 1.0) / (denominator + 1.0)).sum() / num_boxes


def class_error(matched_logits, matched_classes, valid) -> torch.Tensor:
    """100 - top-1 accuracy of matched predictions. matched_logits (B, N, C);
    matched_classes (B, N) int; valid (B, N) bool."""
    correct = (matched_logits.argmax(dim=-1) == matched_classes) & valid
    num = valid.sum().clamp(min=1)
    return 100.0 - 100.0 * correct.sum() / num
