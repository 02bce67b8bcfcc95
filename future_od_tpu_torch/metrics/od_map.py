"""Object-detection mAP (port of future_od_tpu/metrics/od_map.py): the
per-step intermediaries (`prepare_od_map_stuffs`, on the step's device) and
their aggregation over an epoch (`aggregate_mean_average_precision`, in
torch on the CPU).

Per class, the top-K (50) predictions by score claim annotations greedily at
all 10 IoU thresholds (.50:.05:.95) at once; COCO-like size categories
(all / small / medium / large) relative to the image area.

Dims: B batch, C classes (the generic class appended), S = 4 sizes, T = 10
thresholds, M' prediction slots, K kept per class, N annotation slots.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from future_od_tpu_torch.ops.boxes import batched_box_iou

SIZE_CATEGORY_DELIMITERS = ((1 / 24) * (1 / 64), (1 / 4) * (1 / 12))
NUM_THRESHOLDS = 10
TOP_K = 50
NUM_SIZES = 4


def _box_size_categories(boxes: torch.Tensor, imsize) -> torch.Tensor:
    """(B, N, 4) xyxy -> (B, N, S) bool [all, small, medium, large]."""
    H, W = imsize
    areas = (boxes[..., 2] - boxes[..., 0]) * (boxes[..., 3] - boxes[..., 1])
    s0 = SIZE_CATEGORY_DELIMITERS[0] * H * W
    s1 = SIZE_CATEGORY_DELIMITERS[1] * H * W
    small = areas <= s0
    medium = (s0 < areas) & (areas <= s1)
    large = s1 < areas
    return torch.stack([torch.ones_like(small), small, medium, large], dim=-1)


@torch.no_grad()
def prepare_od_map_stuffs(pred_boxes, pred_class_scores, anno_boxes, anno_classes, anno_active,
                          imsize: Tuple[int, int]):
    """pred_boxes (B, M', 4) xyxy pixels, pred_class_scores (B, M', C),
    anno_boxes (B, N, 4), anno_classes (B, N), anno_active (B, N) ->
    confs (T, C, B·K), is_positive (T, C, B·K) bool, size_categories
    (C, S, B·K) bool, num_annos (C, S) int32."""
    B, Mp, C = pred_class_scores.shape
    N = anno_boxes.shape[1]
    K, T = min(TOP_K, Mp), NUM_THRESHOLDS
    device = pred_boxes.device
    thresholds = 0.50 + 0.05 * torch.arange(T, dtype=torch.float32, device=device)

    iou_full = batched_box_iou(pred_boxes, anno_boxes.to(pred_boxes.dtype))  # (B, M', N)
    # top-K per class; a stable descending sort puts equal scores in index
    # order, as lax.top_k does
    scores_t = pred_class_scores.transpose(1, 2)  # (B, C, M')
    order = torch.sort(scores_t, dim=-1, descending=True, stable=True).indices[..., :K]
    confs = torch.gather(scores_t, 2, order).transpose(1, 2)  # (B, K, C)
    ordered_m = order.transpose(1, 2)  # (B, K, C)

    # available: active and of the class; the last class is the generic one
    active_mask = (anno_active == 1)[:, None, :]  # (B, 1, N)
    class_ids = torch.arange(C - 1, device=device, dtype=anno_classes.dtype)
    class_mask = torch.cat(
        [anno_classes[:, None, :] == class_ids[None, :, None],
         torch.ones((B, 1, N), dtype=torch.bool, device=device)],
        dim=1,
    )  # (B, C, N)
    available = active_mask & class_mask

    # iou[b, k, c, n] = iou_full[b, ordered_m[b, k, c], n], unavailable -> 0
    iou = torch.gather(
        iou_full[:, :, None, :].expand(B, Mp, C, N), 1,
        ordered_m[..., None].expand(B, K, C, N),
    )
    iou = torch.where(available[:, None], iou, 0.0)

    # greedy claims over the ranked detections, a claimed mask per threshold
    claimed = torch.zeros((B, T, C, N), dtype=torch.bool, device=device)
    is_positive = torch.zeros((B, T, K, C), dtype=torch.bool, device=device)
    for m in range(K):
        row = torch.where(claimed, 0.0, iou[:, m][:, None])  # (B, T, C, N)
        best_score, best_n = row.amax(dim=-1), row.argmax(dim=-1)
        pos_m = best_score >= thresholds[None, :, None]  # (B, T, C)
        is_positive[:, :, m] = pos_m
        claimed = claimed | (F.one_hot(best_n, N).bool() & pos_m[..., None])

    confs_out = confs.reshape(B * K, C).t()[None].expand(T, C, B * K)
    is_positive_out = is_positive.permute(1, 3, 0, 2).reshape(T, C, B * K)
    size_cats = _box_size_categories(pred_boxes, imsize)  # (B, M', S)
    size_cats = torch.gather(
        size_cats[:, :, None, :].expand(B, Mp, C, NUM_SIZES), 1,
        ordered_m[..., None].expand(B, K, C, NUM_SIZES),
    )  # (B, K, C, S)
    size_cats_out = size_cats.reshape(B * K, C, NUM_SIZES).permute(1, 2, 0)
    anno_sizes = _box_size_categories(anno_boxes, imsize)  # (B, N, S)
    num_annos = (available[:, :, :, None] & anno_sizes[:, None, :, :]).sum(dim=(0, 2))
    return confs_out, is_positive_out, size_cats_out, num_annos.to(torch.int32)


def _get_ap(confs, is_positive, size_categories, num_annos):
    """AP per (class, size) at one threshold (od_map.py:290-314).
    confs, is_positive (C, Nobj); size_categories (C, S, Nobj) bool;
    num_annos (C, S) f32, summed over steps."""
    C, S, Nobj = size_categories.shape
    # a stable sort of -confs, as jnp.argsort's: tied confidences (padded
    # entries among them) keep their order
    ids = torch.argsort(-confs, dim=1, stable=True)[:, None, :].expand(C, S, Nobj)
    is_positive = is_positive[:, None, :] & size_categories
    is_positive = torch.gather(is_positive, 2, ids)
    size_categories = torch.gather(size_categories, 2, ids)
    precision = torch.cumsum(is_positive, dim=2, dtype=torch.int32) / (
        torch.cumsum(size_categories, dim=2, dtype=torch.int32) + 1e-5)
    return (precision * is_positive).sum(dim=2) / num_annos


def _ap_all_thresholds(confs, is_positive, size_categories, num_annos):
    """(T, C, S) AP: `_get_ap` at each threshold."""
    num_annos = num_annos.to(torch.float32)
    return torch.stack([_get_ap(c, p, size_categories, num_annos)
                        for c, p in zip(confs, is_positive)])


def aggregate_mean_average_precision(
    confs: np.ndarray,  # (T, C, num_objects), concatenated over steps
    is_positive: np.ndarray,
    size_categories: np.ndarray,  # (C, S, num_objects)
    num_annos: np.ndarray,  # (C, S, num_steps)
) -> Dict[str, np.ndarray]:
    """The epoch's AP dict from the per-step intermediaries (od_map.py:
    317-364): per-threshold APs, their class and threshold averages, and the
    generic-objectness class apart. NaN where a class has no annotations,
    which the nan-means skip, as in the reference."""
    num_annos_total = torch.as_tensor(np.asarray(num_annos).sum(axis=2))
    with torch.no_grad():
        ap = _ap_all_thresholds(
            torch.as_tensor(np.asarray(confs)), torch.as_tensor(np.asarray(is_positive)),
            torch.as_tensor(np.asarray(size_categories)), num_annos_total,
        ).numpy()  # (T, C, S)
    with np.errstate(invalid="ignore"):
        return {
            "all": ap[:, 0:-1, :],
            "classavg": np.nanmean(ap[:, 0:-1, :], axis=1),
            "threshavg": np.nanmean(ap[:, 0:-1, :], axis=0),
            "classavg threshavg": np.nanmean(ap[:, 0:-1, :], axis=(0, 1)),
            "generic": ap[:, -1, :],
            "generic threshavg": np.nanmean(ap[:, -1, :], axis=0),
        }
