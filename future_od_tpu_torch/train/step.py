"""Inference entry point (port of future_od_tpu/train/step.py::make_inference_fn).
The training and eval steps are not ported yet."""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from future_od_tpu_torch.models.st_detr import normalize_outputs, post_process
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def to_device_batch(data: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """numpy arrays and tensors of a batch dict -> tensors on `device`."""
    return {
        k: torch.as_tensor(v, device=device)
        if isinstance(v, (np.ndarray, torch.Tensor)) else v
        for k, v in data.items()
    }


def make_inference_fn(model: torch.nn.Module, device: DeviceLike = None) -> Callable:
    """Returns infer(data) -> post-processed output dict (the deployment /
    serving path; no targets needed). `data` is the JAX package's batch
    dict, as numpy arrays or tensors; it is moved to `device` (default
    CUDA; raises without a card), where the model must live."""
    device = resolve_device(device)
    model.eval()

    def infer(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(data, device)
        with torch.inference_mode():
            out = model(batch)
            _, pred_logits, pred_boxes = normalize_outputs(out)
            output, _, _ = post_process(pred_logits, pred_boxes, batch)
        return output

    return infer
