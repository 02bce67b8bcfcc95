"""The non-learned tracker future-predictor of the tracker baseline (port of
future_od_tpu/models/tracker.py): host-side numpy.

Detections of two neighbouring frames are assigned by the exact linear sum
assignment of a center-distance + class-disparity cost, and the matched box
centers (and optionally dimensions) are extrapolated to the future frame.
The assignment is the exact Jonker-Volgenant solver of `ops/native_lap.py`,
as in the JAX module.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from future_od_tpu_torch.ops import native_lap


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


class TrackerFuturePredictor:
    """dim_extrapolation: None | "linear" | "percentual" | "average"."""

    def __init__(self, dim_extrapolation: Optional[str] = None):
        if dim_extrapolation not in (None, "linear", "percentual", "average"):
            raise ValueError(f"dim_extrapolation {dim_extrapolation!r}")
        self._dim_extrapolation = dim_extrapolation

    def __call__(self, pred1: Dict[str, np.ndarray], pred2: Dict[str, np.ndarray],
                 temporal_offsets: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
        """pred1 = previous frame, pred2 = current frame, each
        {"pred_logits": (B, M, C), "pred_boxes": (B, M, 4) cxcywh in [0, 1]};
        temporal_offsets (B, 3) in seconds, or None for equal steps. Returns
        the extrapolated future prediction of the same layout."""
        boxes1 = np.asarray(pred1["pred_boxes"], np.float32)
        boxes2 = np.asarray(pred2["pred_boxes"], np.float32)
        logits1 = np.asarray(pred1["pred_logits"], np.float32)
        logits2 = np.asarray(pred2["pred_logits"], np.float32)
        B, M, _ = boxes2.shape

        # cost: 0.5 center L2 distance + 0.5 max-abs sigmoid disparity
        d_center = np.linalg.norm(boxes2[:, :, None, 0:2] - boxes1[:, None, :, 0:2], axis=-1)
        d_class = np.abs(
            _sigmoid(logits2)[:, :, None, :] - _sigmoid(logits1)[:, None, :, :]
        ).max(-1)
        cost = 0.5 * d_center + 0.5 * d_class  # (B, M, N)

        mapping = np.full((B, M), -1, np.int64)
        for b in range(B):
            rows, cols = native_lap.linear_sum_assignment(cost[b])
            mapping[b, rows] = cols

        if temporal_offsets is None:
            factor = 1.0
        else:
            t = np.asarray(temporal_offsets, np.float32)
            factor = ((t[:, 2] - t[:, 1]) / (t[:, 1] - t[:, 0]))[:, None, None]

        has_match = mapping != -1
        safe_map = np.where(has_match, mapping, 0)
        corr_boxes1 = np.take_along_axis(boxes1, safe_map[..., None], axis=1)
        corr_boxes1 = np.where(has_match[..., None], corr_boxes1, boxes2)

        dim = self._extrapolate_dim(boxes2, corr_boxes1, factor)
        pos = boxes2[..., 0:2] + (boxes2[..., 0:2] - corr_boxes1[..., 0:2]) * factor
        out_boxes = np.concatenate([pos, dim], axis=-1)

        corr_logits1 = np.take_along_axis(logits1, safe_map[..., None], axis=1)
        corr_logits1 = np.where(has_match[..., None], corr_logits1, 0.0)
        out_logits = 0.5 * (logits2 + corr_logits1)
        return {"pred_boxes": out_boxes, "pred_logits": out_logits}

    def _extrapolate_dim(self, boxes2, corr_boxes1, factor):
        wh2, wh1 = boxes2[..., 2:4], corr_boxes1[..., 2:4]
        if self._dim_extrapolation is None:
            return wh2
        if self._dim_extrapolation == "linear":
            return np.clip(wh2 + (wh2 - wh1) * factor, 0.0, None)
        if self._dim_extrapolation == "percentual":
            return wh2 * (wh2 / wh1) ** factor
        return (wh2 + wh1) / 2.0  # "average"
