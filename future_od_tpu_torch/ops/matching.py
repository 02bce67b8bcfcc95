"""Set-prediction matching (port of future_od_tpu/ops/matching.py).

- `matching_cost` builds the (B, M, N) conditional-DETR cost (focal class
  cost + L1 on cxcywh - GIoU) over dense masked targets, without gradient.
- `auction_assignment` solves it with the JAX package's batched Jacobi
  auction, round for round: a single phase from zero prices, eps 1e-3 on the
  benefit normalized to max |benefit| = 1, at most 1000 bidding rounds.
  Each problem of the batch stops when all its active targets own a query,
  as JAX's vmapped while_loop does, and the rounds each took are returned on
  request. The top-2 per target is one max plus a masked second max, and
  every tie goes to the lowest index (JAX's argmax and top_k order), so the
  indices equal JAX's. The loop is Python, with one host read per round for
  its stop test.
- `hungarian_assignment` is the exact arm: the Jonker-Volgenant solver of
  `ops/native_lap.py` (C++ on the host) per image over its active columns.

Contract of both solvers: (B, N) int64 query index per target slot, M for
unmatched or inactive slots.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from future_od_tpu_torch.ops import native_lap
from future_od_tpu_torch.ops.boxes import box_cxcywh_to_xyxy, generalized_box_iou

NEG_INF = -1e30


def matching_cost(pred_logits, pred_boxes, targets: Dict[str, torch.Tensor],
                  cost_class: float = 2.0, cost_bbox: float = 5.0, cost_giou: float = 2.0,
                  focal_alpha: float = 0.25, focal_gamma: float = 2.0) -> torch.Tensor:
    """pred_logits (B, M, C), pred_boxes (B, M, 4) cxcywh, targets {"boxes"
    (B, N, 4) cxcywh, "labels" (B, N), "active" (B, N)} -> (B, M, N) cost.
    Columns of inactive targets are meaningless; the solvers skip them."""
    pred_logits, pred_boxes = pred_logits.detach(), pred_boxes.detach()
    prob = torch.sigmoid(pred_logits)
    pos_cost = focal_alpha * (1.0 - prob) ** focal_gamma * (-torch.log(prob + 1e-8))
    neg_cost = (1.0 - focal_alpha) * prob ** focal_gamma * (-torch.log(1.0 - prob + 1e-8))
    # labels clamped into [0, C): inactive slots may hold anything
    labels = targets["labels"].long().clamp(0, pred_logits.shape[-1] - 1)
    cls_cost = torch.gather(
        pos_cost - neg_cost, 2,
        labels[:, None, :].expand(-1, pred_logits.shape[1], -1),
    )
    l1_cost = (pred_boxes[:, :, None, :] - targets["boxes"][:, None, :, :]).abs().sum(-1)
    giou_cost = -generalized_box_iou(
        box_cxcywh_to_xyxy(pred_boxes), box_cxcywh_to_xyxy(targets["boxes"])
    )
    return cost_bbox * l1_cost + cost_class * cls_cost + cost_giou * giou_cost


def auction_assignment(cost: torch.Tensor, active: torch.Tensor, max_iters: int = 1000,
                       eps: float = 1e-3, return_rounds: bool = False):
    """Batched Jacobi auction: persons are target slots, objects queries.
    cost (B, M, N), active (B, N) -> (B, N) int64 query per slot (M when
    unmatched); with return_rounds, also the (B,) int32 bidding rounds."""
    B, M, N = cost.shape
    device = cost.device
    active = active.bool()
    neg_inf = torch.tensor(NEG_INF, dtype=torch.float32, device=device)
    benefit = -cost.detach().float().transpose(1, 2)  # (B, N, M)
    scale = torch.where(active[:, :, None], benefit, 0.0).abs().amax(dim=(1, 2)).clamp(min=1e-6)
    benefit = torch.where(active[:, :, None], benefit / scale[:, None, None], neg_inf)
    eps_t = torch.tensor(eps, dtype=torch.float32, device=device)
    obj_ids = torch.arange(M, device=device)
    person_ids = torch.arange(N, device=device)

    price = torch.zeros((B, M), dtype=torch.float32, device=device)
    owner = torch.full((B, N), -1, dtype=torch.int64, device=device)
    obj_owner = torch.full((B, M), -1, dtype=torch.int64, device=device)
    rounds = torch.zeros((B,), dtype=torch.int32, device=device)
    spill = torch.full((B, 1), -1, dtype=torch.int64, device=device)
    for _ in range(max_iters):
        unassigned = active & (owner < 0)
        running = unassigned.any(dim=1)  # (B,)
        if not bool(running.any()):  # the round's one host read
            break
        values = torch.where(unassigned[:, :, None], benefit - price[:, None, :], neg_inf)
        best_i = values.argmax(dim=2)  # first of equal maxima, as top_k
        w1 = values.gather(2, best_i[..., None])[..., 0]
        second = values.scatter(2, best_i[..., None], float("-inf")).amax(dim=2)
        w2 = torch.where(second > NEG_INF / 2, second, w1 - 1.0)
        bid = price.gather(1, best_i) + (w1 - w2) + eps_t  # (B, N)

        # a problem that has stopped has no unassigned target, so it places
        # no bid and its state stays, as under JAX's vmapped while_loop
        bidding = unassigned[:, :, None] & (best_i[:, :, None] == obj_ids)
        bid_matrix = torch.where(bidding, bid[:, :, None], neg_inf)  # (B, N, M)
        win_bid = bid_matrix.amax(dim=1)
        win_person = bid_matrix.argmax(dim=1)  # (B, M)
        has_bid = win_bid > NEG_INF / 2

        price = torch.where(has_bid, win_bid, price)
        prev_owner = torch.where(has_bid, obj_owner, -1)
        displaced = (prev_owner[:, None, :] == person_ids[None, :, None]).any(dim=2)
        # winners take their objects; a person bids on one object, so wins at
        # most one, and objects without a bid write to a spill column
        owner = torch.cat([torch.where(displaced, -1, owner), spill], dim=1).scatter(
            1, torch.where(has_bid, win_person, N), obj_ids.expand(B, M))[:, :N]
        obj_owner = torch.where(has_bid, win_person, obj_owner)
        rounds = rounds + running.to(torch.int32)
    idx = torch.where(active & (owner >= 0), owner, M)
    return (idx, rounds) if return_rounds else idx


def hungarian_host(cost: np.ndarray, active: np.ndarray) -> np.ndarray:
    """The exact assignment of (B, M, N) f32 costs over each image's active
    columns ((B, N) bool): (B, N) int64 query index per slot, M where
    unmatched or inactive (the JAX package's `_hungarian_host`)."""
    B, M, N = cost.shape
    out = np.full((B, N), M, dtype=np.int64)
    for b in range(B):
        cols = np.nonzero(active[b])[0]
        if len(cols) == 0:
            continue
        rows, sub_cols = native_lap.linear_sum_assignment(cost[b][:, cols])
        out[b, cols[sub_cols]] = rows
    return out


def hungarian_assignment(cost: torch.Tensor, active: torch.Tensor, return_rounds: bool = False):
    """Exact assignment on the host (`hungarian_host`). Same contract as
    `auction_assignment`; rounds are 0."""
    B = cost.shape[0]
    idx = torch.from_numpy(hungarian_host(cost.detach().float().cpu().numpy(),
                                          active.bool().cpu().numpy())).to(cost.device)
    if return_rounds:
        return idx, torch.zeros((B,), dtype=torch.int32, device=cost.device)
    return idx


SOLVERS = {
    "auction": auction_assignment,
    "hungarian": hungarian_assignment,
}
