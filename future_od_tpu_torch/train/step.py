"""Train step and inference entry point (port of future_od_tpu/train/step.py:
`make_train_step` with its helpers, and `make_inference_fn`).

One train step: forward in training mode -> matching + set loss -> backward
-> global-norm clip -> AdamW -> post-processing -> mAP intermediaries. The
non-finite guard keeps the old parameters and optimizer state when the
global gradient norm is not finite. The eval step, mixed precision,
gradient accumulation and the host-matched steps are not ported yet.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import numpy as np
import torch

from future_od_tpu_torch.metrics.od_map import prepare_od_map_stuffs
from future_od_tpu_torch.models.set_criterion import CriterionConfig
from future_od_tpu_torch.models.st_detr import compute_loss, normalize_outputs, post_process
from future_od_tpu_torch.ops.misc import video_hw
from future_od_tpu_torch.train.optimizer import AdamWClipped, clip_by_global_norm_, global_norm
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def to_device_batch(data: Dict[str, Any], device: torch.device) -> Dict[str, Any]:
    """numpy arrays and tensors of a batch dict -> tensors on `device`."""
    return {
        k: torch.as_tensor(v, device=device)
        if isinstance(v, (np.ndarray, torch.Tensor)) else v
        for k, v in data.items()
    }


def forward_and_loss(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                     data: Dict[str, torch.Tensor], pred_idx_all=None, num_boxes=None):
    """(loss, (stats, pred_logits, pred_boxes)) of one forward in the model's
    current mode; pred_idx_all injects the matcher's indices."""
    out = model(data)
    annotated, pred_logits, pred_boxes = normalize_outputs(out)
    loss, stats = compute_loss(annotated, data, criterion_cfg, pred_idx_all, num_boxes)
    return loss, (stats, pred_logits, pred_boxes)


@torch.no_grad()
def postproc_and_map(pred_logits, pred_boxes, data: Dict[str, torch.Tensor]):
    """(post-processed output, the step's mAP intermediaries)."""
    output, anno_scores, anno_boxes = post_process(pred_logits, pred_boxes, data)
    od_map_stuffs = prepare_od_map_stuffs(
        anno_boxes, anno_scores, data["boxes"], data["classes"], data["active"],
        video_hw(data["video"]),
    )
    return output, od_map_stuffs


def step_seed(seed: int, step: int) -> int:
    """The torch seed of step `step` of a run seeded `seed` (the counterpart
    of jax.random.fold_in(rng, step))."""
    return int(np.random.SeedSequence([int(seed), int(step)]).generate_state(1)[0])


def make_train_step(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                    optimizer: AdamWClipped, skip_nonfinite: bool = True,
                    device: DeviceLike = None, mixed_precision: bool = False,
                    accum_steps: int = 1) -> Callable:
    """Returns train_step(data, seed) -> (loss, stats, od_map_stuffs,
    output), which updates `model` and `optimizer` in place and counts
    steps. `data` is the JAX package's batch dict (numpy arrays or tensors),
    moved to `device` (default CUDA; raises without a card), where the model
    must live. `optimizer` is `train/optimizer.py::build_optimizer`'s; its
    max_norm sets the clip.

    Dropout of step s is seeded from (seed, s) inside torch.random.fork_rng:
    two runs with one seed are identical, and a step leaves the global RNG as
    it found it. The dropout streams cannot equal the JAX package's (rbg),
    except inside the train flash kernels, whose mask is a hash of a seed.

    skip_nonfinite: when the global gradient norm is not finite, the step
    keeps the old parameters and optimizer state; stats["nonfinite_skipped"]
    is 1.0 then (else 0.0). The step counter advances either way."""
    if mixed_precision:
        raise NotImplementedError(
            "mixed_precision is not ported yet (ROADMAP.md Queue 1, Slice C item 11)")
    if accum_steps != 1:
        raise NotImplementedError(
            "accum_steps > 1 is not ported yet (ROADMAP.md Queue 1, Slice C item 11)")
    device = resolve_device(device)
    params = list(optimizer.parameters())
    fork_devices = []
    if device.type == "cuda":
        fork_devices = [torch.cuda.current_device() if device.index is None else device.index]
    steps = [0]

    def train_step(data: Dict[str, Any], seed: int):
        batch = to_device_batch(data, device)
        model.train()
        optimizer.zero_grad(set_to_none=True)
        with torch.random.fork_rng(devices=fork_devices):
            torch.manual_seed(step_seed(seed, steps[0]))
            loss, (stats, pred_logits, pred_boxes) = forward_and_loss(
                model, criterion_cfg, batch)
            loss.backward()
        grads = [p.grad for p in params if p.grad is not None]
        norm = global_norm(grads)
        ok = bool(torch.isfinite(norm))  # the step's one decision on the host
        if ok or not skip_nonfinite:
            if optimizer.max_norm:
                clip_by_global_norm_(grads, norm, optimizer.max_norm)
            optimizer.step()
        stats = {k: v.detach() for k, v in stats.items()}
        if skip_nonfinite:
            stats["nonfinite_skipped"] = torch.tensor(0.0 if ok else 1.0, device=device)
        steps[0] += 1
        output, od_map_stuffs = postproc_and_map(pred_logits.detach(), pred_boxes.detach(), batch)
        return loss.detach(), stats, od_map_stuffs, output

    train_step.steps = steps
    return train_step


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
