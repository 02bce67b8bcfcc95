"""Small numeric helpers (port of future_od_tpu/ops/misc.py)."""
from __future__ import annotations

import torch


def inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Clamped logit, the inverse of sigmoid on [0, 1]: clamp x to [0, 1],
    floor numerator and denominator at eps."""
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def video_hw(video) -> tuple:
    """Logical (H, W) pixels of a (B, L, H, W, C) video. 12-channel (2x2)
    and 48-channel (4x4) videos are space-to-depth packed, so they report
    their block factor times the stored spatial dims."""
    H, W, C = video.shape[2], video.shape[3], video.shape[-1]
    if C == 12:
        return 2 * H, 2 * W
    if C == 48:
        return 4 * H, 4 * W
    return H, W
