"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    another. Raises when CUDA is asked for (explicitly or by default) and
    there is no card — there is no silent CPU fallback."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "future_od_tpu_torch runs on CUDA by default, but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path on the CPU"
        )
    return device
