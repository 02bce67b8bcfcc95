"""Train, eval and inference steps (port of future_od_tpu/train/step.py:
`make_train_step`, `make_eval_step`, `make_tracker_eval_step`,
`make_grad_report` with `dead_param_names`, and `make_inference_fn`).

One train step: forward in training mode -> matching + set loss -> backward
-> global-norm clip -> AdamW -> post-processing -> mAP intermediaries. The
non-finite guard keeps the old parameters and optimizer state when the
global gradient norm is not finite. An eval step is the forward in eval mode,
the loss over every decoder level (the JAX model returns the aux levels in
eval too) and the same post-processing. The train step takes the JAX
package's mixed precision and exact gradient accumulation; the host-matched
steps are not ported yet.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from future_od_tpu_torch.metrics.od_map import prepare_od_map_stuffs
from future_od_tpu_torch.models.precision import half_state, jax_promotion
from future_od_tpu_torch.models.set_criterion import CriterionConfig
from future_od_tpu_torch.models.st_detr import (
    SpatioTemporalDETR,
    compute_loss,
    normalize_outputs,
    post_process,
)
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
                     data: Dict[str, torch.Tensor], pred_idx_all=None, num_boxes=None,
                     aux_levels: bool = False):
    """(loss, (stats, pred_logits, pred_boxes)) of one forward in the model's
    current mode; pred_idx_all injects the matcher's indices; aux_levels asks
    the model for its aux levels in eval mode too, as the JAX model returns
    them (its inference program drops them)."""
    return loss_of_outputs(model(data, aux_levels=aux_levels), data, criterion_cfg,
                           pred_idx_all, num_boxes)


def half_forward_and_loss(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                          data: Dict[str, torch.Tensor], pred_idx_all=None, num_boxes=None):
    """forward_and_loss in training mode under the JAX package's mixed
    precision: the forward on bf16 copies of every f32 parameter and buffer
    under jnp's type promotion (`models/precision.py`), f32 video cast to
    bf16 and uint8 video left uint8 (the JAX `_to_half` and `_cast_data`).
    The criterion, which casts its inputs to f32, runs as in f32; the
    gradients land in f32 on the master parameters."""
    if data["video"].dtype == torch.float32:
        data = dict(data, video=data["video"].to(torch.bfloat16))
    with jax_promotion():
        out = torch.func.functional_call(model, half_state(model), (data,))
    return loss_of_outputs(out, data, criterion_cfg, pred_idx_all, num_boxes)


def loss_of_outputs(out, data, criterion_cfg: CriterionConfig, pred_idx_all=None,
                    num_boxes=None):
    annotated, pred_logits, pred_boxes = normalize_outputs(out, data)
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


@contextlib.contextmanager
def seeded(seed: int, step: int, device: torch.device, micro: Optional[int] = None):
    """torch's generators seeded from (seed, step) inside, restored after:
    the dropout of step `step` of a run seeded `seed`; with `micro`, that of
    its micro-batch `micro` (the JAX package's fold_in of k)."""
    devices = []
    if device.type == "cuda":
        devices = [torch.cuda.current_device() if device.index is None else device.index]
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(step_seed(seed, step) if micro is None
                          else step_seed(step_seed(seed, step), micro))
        yield


# each stat's combination over micro-batches (train_step_accum): the
# loss-derived stats are sums over the full batch's num_boxes and the drop
# count is a count, so they add; the rounds take the max; the rest are means
_ADDED_STATS = ("labels", "box_l1", "box_giou", "matcher_dropped")


def _combine_stats(total: Optional[Dict[str, torch.Tensor]], stats: Dict[str, torch.Tensor],
                   K: int) -> Dict[str, torch.Tensor]:
    stats = {k: v.detach().float() for k, v in stats.items()}
    if total is None:
        return {k: v if k in _ADDED_STATS or k == "matcher_rounds" else v / K
                for k, v in stats.items()}
    return {k: torch.maximum(total[k], v) if k == "matcher_rounds"
            else total[k] + (v if k in _ADDED_STATS else v / K)
            for k, v in stats.items()}


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

    mixed_precision: the forward and backward run on bf16 copies of every f32
    parameter and buffer under jnp's type promotion (`models/precision.py`),
    with f32 video cast to bf16 and uint8 video left uint8; the master
    parameters, their gradients, AdamW's state and the loss stay f32, with no
    loss scaling (the JAX `_to_half` and `_cast_data`).

    accum_steps: K > 1 splits the batch into K interleaved micro-batches
    (micro-batch k takes rows k::K) and runs the forward and backward of one
    at a time, so only one micro-batch's activations are held. Each micro
    loss is normalised by the full batch's num_boxes, so the summed
    gradients are the whole batch's; one clip and one AdamW update follow.
    Post-processing and the mAP intermediaries run once, on the reassembled
    batch. Each micro-batch draws its own dropout; the stats combine as the
    JAX `train_step_accum` combines them. B % K != 0 raises ValueError.

    skip_nonfinite: when the global gradient norm is not finite, the step
    keeps the old parameters and optimizer state; stats["nonfinite_skipped"]
    is 1.0 then (else 0.0). The step counter advances either way."""
    device = resolve_device(device)
    params = list(optimizer.parameters())
    steps = [0]
    K = int(accum_steps)

    def loss_of(batch, num_boxes=None):
        fn = half_forward_and_loss if mixed_precision else forward_and_loss
        return fn(model, criterion_cfg, batch, num_boxes=num_boxes)

    def train_step(data: Dict[str, Any], seed: int):
        batch = to_device_batch(data, device)
        B = batch["active"].shape[0]
        if B % K:
            raise ValueError(f"batch {B} not divisible by accum_steps {K}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        num_boxes = batch["active"].sum().float().clamp(min=1.0)
        split = {k: v for k, v in batch.items()
                 if torch.is_tensor(v) and v.ndim and v.shape[0] == B}
        loss, stats, outputs = 0.0, None, []
        for k in range(K):
            micro = {**batch, **{key: v[k::K] for key, v in split.items()}}
            with seeded(seed, steps[0], device, micro=k if K > 1 else None):
                loss_k, (stats_k, logits_k, boxes_k) = loss_of(micro, num_boxes)
                loss_k.backward()
            loss = loss + loss_k.detach()
            stats = _combine_stats(stats, stats_k, K)
            outputs.append((logits_k.detach(), boxes_k.detach()))
        # micro-batch k's row j is row j*K + k of the batch
        pred_logits, pred_boxes = (torch.stack(list(out), 1).flatten(0, 1)
                                   for out in zip(*outputs))
        grads = [p.grad for p in params if p.grad is not None]
        norm = global_norm(grads)
        ok = bool(torch.isfinite(norm))  # the step's one decision on the host
        if ok or not skip_nonfinite:
            if optimizer.max_norm:
                clip_by_global_norm_(grads, norm, optimizer.max_norm)
            optimizer.step()
        if skip_nonfinite:
            stats["nonfinite_skipped"] = torch.tensor(0.0 if ok else 1.0, device=device)
        steps[0] += 1
        output, od_map_stuffs = postproc_and_map(pred_logits, pred_boxes, batch)
        return loss, stats, od_map_stuffs, output

    train_step.steps = steps
    return train_step


def make_eval_step(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                   device: DeviceLike = None) -> Callable:
    """Returns eval_step(data) -> (loss, stats, od_map_stuffs, output): the
    forward in eval mode without autograd, the loss with every decoder
    level, post-processing and the mAP intermediaries. `data` is the JAX
    package's batch dict, moved to `device` (default CUDA; raises without a
    card), where the model must live."""
    device = resolve_device(device)

    def eval_step(data: Dict[str, Any]):
        batch = to_device_batch(data, device)
        model.eval()
        with torch.no_grad():
            loss, (stats, pred_logits, pred_boxes) = forward_and_loss(
                model, criterion_cfg, batch, aux_levels=True)
            output, od_map_stuffs = postproc_and_map(pred_logits, pred_boxes, batch)
        return loss, stats, od_map_stuffs, output

    return eval_step


def make_tracker_eval_step(model: torch.nn.Module, criterion_cfg: CriterionConfig, tracker,
                           host_matched: bool = False, device: DeviceLike = None) -> Callable:
    """Returns eval_step(data) -> (loss, stats, od_map_stuffs, output) for
    the tracker baseline (`TrackerBaselineCore` at L >= 2), with
    `make_eval_step`'s signature: the per-frame detections of the past
    frames on `device` (default CUDA; raises without a card), the host-side
    `tracker` (models/tracker.py) on the last two of them as numpy, then the
    loss, post-processing and mAP intermediaries of its extrapolated future
    prediction back on the device. `host_matched=True` (the JAX package's
    split around a host matcher, for backends without host callbacks) is
    not ported and raises NotImplementedError."""
    if host_matched:
        raise NotImplementedError(
            "make_tracker_eval_step(host_matched=True), the host-matched split of the step, "
            "is not ported (ROADMAP.md Queue 1 item 6, 1c)")
    device = resolve_device(device)

    def eval_step(data: Dict[str, Any]):
        batch = to_device_batch(data, device)
        model.eval()
        with torch.no_grad():
            preds = model(batch)["per_frame_preds"]
            p0, p1 = ({k: p[k].float().cpu().numpy() for k in ("pred_logits", "pred_boxes")}
                      for p in preds[:2])
            offsets = data.get("temporal_offsets")
            future = tracker(p0, p1, None if offsets is None else np.asarray(
                offsets.cpu() if torch.is_tensor(offsets) else offsets))
            future = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                      for k, v in future.items()}
            loss, (stats, pred_logits, pred_boxes) = loss_of_outputs(future, batch,
                                                                     criterion_cfg)
            output, od_map_stuffs = postproc_and_map(pred_logits, pred_boxes, batch)
        return loss, stats, od_map_stuffs, output

    return eval_step


def make_grad_report(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                     device: DeviceLike = None) -> Callable:
    """Returns report(data, seed, step) -> {parameter name: the L2 norm of
    its gradient on `data`} (f32 scalars on `device`), from one forward in
    training mode with the dropout of train step `step` and one backward
    that leaves the parameters' `.grad` as it was. Frozen parameters
    (requires_grad False) and trainable ones the loss does not reach report
    0. The port of the JAX epoch-1 audit: under autograd a gradient that is
    identically zero on a real batch marks a dead branch or a mis-masked
    parameter, as the reference's `grad is None` check (trainer.py:181-185)
    does."""
    device = resolve_device(device)

    def report(data: Dict[str, Any], seed: int, step: int) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(data, device)
        model.train()
        named = list(model.named_parameters())
        trainable = [p for _, p in named if p.requires_grad]
        with seeded(seed, step, device):
            loss, _ = forward_and_loss(model, criterion_cfg, batch)
            grads = iter(torch.autograd.grad(loss, trainable, allow_unused=True))
        norms = {}
        for name, p in named:
            g = next(grads) if p.requires_grad else None
            norms[name] = (torch.zeros((), device=device) if g is None
                           else torch.sqrt(g.float().square().sum()))
        return norms

    return report


def dead_param_names(grad_norms: Dict[str, Any], labels: Dict[str, str]) -> List[str]:
    """The names whose gradient norm is exactly zero, leaving out the
    parameters frozen on purpose (label "frozen", train/optimizer.py)."""
    return [name for name, norm in grad_norms.items()
            if labels[name] != "frozen" and float(norm) == 0.0]


class InferenceProgram(SpatioTemporalDETR):
    """The deployment path as one module: the model's forward on a batch
    dict, then `normalize_outputs` and `post_process`. It shares the
    model's core, so its state is the model's, under the model's keys
    (`serve/export.py::export_inference` exports it)."""

    def __init__(self, model: SpatioTemporalDETR):
        super().__init__(model._model, model.args)

    def forward(self, data: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        _, pred_logits, pred_boxes = normalize_outputs(super().forward(data), data)
        return post_process(pred_logits, pred_boxes, data)[0]


def make_inference_fn(model: torch.nn.Module, device: DeviceLike = None) -> Callable:
    """Returns infer(data) -> post-processed output dict (the deployment /
    serving path; no targets needed). `data` is the JAX package's batch
    dict, as numpy arrays or tensors; it is moved to `device` (default
    CUDA; raises without a card), where the model must live."""
    device = resolve_device(device)
    program = InferenceProgram(model.eval()).eval()

    def infer(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(data, device)
        with torch.inference_mode():
            return program(batch)

    return infer
