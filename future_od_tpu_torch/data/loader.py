"""Host-side input packing (the start of a port of future_od_tpu/data/loader.py)."""
from __future__ import annotations

import numpy as np


def host_space_to_depth(video: np.ndarray) -> np.ndarray:
    """(..., H, W, C) -> (..., H/2, W/2, 4C): host-side 2x2 pixel packing in
    (di, dj, c) channel order. The pack layout must match
    models/resnet.py::space_to_depth (the on-device equivalent), the
    (4, 4, 12, 64) s2d stem kernel, and device_normalize's channel-tiled
    statistics. A video packed here feeds a `space_to_depth` model as it is,
    with no transpose on the device."""
    v = np.asarray(video)
    *lead, H, W, C = v.shape
    v = v.reshape(*lead, H // 2, 2, W // 2, 2, C)
    v = np.moveaxis(v, v.ndim - 4, v.ndim - 3)  # (..., H/2, W/2, di, dj, C)
    return np.ascontiguousarray(v).reshape(*lead, H // 2, W // 2, 4 * C)
