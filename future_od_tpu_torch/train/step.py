"""Train, eval and inference steps (port of future_od_tpu/train/step.py:
`make_train_step`, `make_eval_step`, `make_host_matched_steps`,
`make_tracker_eval_step`, `make_grad_report` with `dead_param_names`, and
`make_inference_fn`).

One train step: forward in training mode -> matching + set loss -> backward
-> global-norm clip -> AdamW -> post-processing -> mAP intermediaries. The
non-finite guard keeps the old parameters and optimizer state when the
global gradient norm is not finite. An eval step is the forward in eval mode,
the loss over every decoder level (the JAX model returns the aux levels in
eval too) and the same post-processing. The train step takes the JAX
package's mixed precision and exact gradient accumulation. The host-matched
steps are these steps with the criterion's exact matcher, which solves every
level on the host (`ops/matching.py::hungarian_assignment`).

Data parallelism (`mesh=`, a `parallel/mesh.py` mesh whose data axis is the
ranks of a process group): the JAX package runs one program over the global
batch; here each rank computes its contiguous block of rows and the step
reduces so that the numbers are the global program's. The active-target
count is summed over the ranks before the loss, so each rank's loss is its
rows' sum over the global `num_boxes` and the sum of the ranks' gradients
is the global gradient; the gradients are summed once a step (one bucketed
all-reduce, after the last micro-batch and before the clip), so the clip
and AdamW see the whole batch's; the stats are reduced over the rows
(`reduce_stats`). The mAP intermediaries and the output stay the rank's
rows. Each rank draws its own dropout (the rank is folded into the seed).

Tensor parallelism (a mesh whose model axis is above 1, the model cut by
`parallel/mesh.py::shard_model`): the ranks of a model group hold the same
rows and a share each of the transformer's projections, and the blocks
reduce over the model group inside the forward and backward
(`models/layers.py`). Every data-parallel reduction above runs over the
data group only (the ranks of one model index), so no row counts twice;
the global norm sums the shares' squares over the model group
(`train/optimizer.py::global_norm`); the dropout seed folds in the data
place, so a model group draws one stream, as one process would.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from future_od_tpu_torch.metrics.od_map import prepare_od_map_stuffs
from future_od_tpu_torch.models.precision import half_state, jax_promotion
from future_od_tpu_torch.models.set_criterion import CriterionConfig, matched_targets
from future_od_tpu_torch.models.st_detr import (
    STAT_IDFS,
    SpatioTemporalDETR,
    compute_loss,
    normalize_outputs,
    post_process,
)
from future_od_tpu_torch.models.resnet import int8_calibration
from future_od_tpu_torch.ops.misc import video_hw
from future_od_tpu_torch.ops.quant import assert_calibrated
from future_od_tpu_torch.parallel import distributed
from future_od_tpu_torch.parallel.mesh import Mesh, sharded_params, tensor_parallel
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
                          data: Dict[str, torch.Tensor], pred_idx_all=None, num_boxes=None,
                          aux_levels: bool = False):
    """forward_and_loss under the JAX package's mixed precision: the forward
    on bf16 copies of every f32 parameter and buffer under jnp's type
    promotion (`models/precision.py`), f32 video cast to bf16 and uint8 video
    left uint8 (the JAX `_to_half` and `_cast_data`). The criterion, which
    casts its inputs to f32, runs as in f32; the gradients land in f32 on
    the master parameters."""
    if data["video"].dtype == torch.float32:
        data = dict(data, video=data["video"].to(torch.bfloat16))
    with jax_promotion():
        out = torch.func.functional_call(model, half_state(model), (data,),
                                         {"aux_levels": aux_levels})
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
def seeded(seed: int, step: int, device: torch.device, micro: Optional[int] = None,
           rank: Optional[int] = None):
    """torch's generators seeded from (seed, step) inside, restored after:
    the dropout of step `step` of a run seeded `seed`; with `micro`, that of
    its micro-batch `micro` (the JAX package's fold_in of k); with `rank`,
    that of a data-parallel rank's rows (the JAX program draws a mask for
    every row of the global batch, so no two ranks may draw the same)."""
    devices = []
    if device.type == "cuda":
        devices = [torch.cuda.current_device() if device.index is None else device.index]
    with torch.random.fork_rng(devices=devices):
        value = step_seed(seed, step)
        if micro is not None:
            value = step_seed(value, micro)
        if rank is not None:
            value = step_seed(value, rank)
        torch.manual_seed(value)
        yield


def data_parallel(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """The mesh a step reduces over (its grid the ranks of a process
    group), or None for a step of one process. A mesh of several devices in
    one process raises ValueError: a train or eval step runs one process a
    device."""
    if mesh is None:
        return None
    if not mesh.distributed:
        if mesh.shape["data"] == 1 and mesh.shape["model"] == 1:
            return None
        raise ValueError(
            f"{mesh}: a train or eval step runs one process a device; start one rank a "
            "device (torchrun, or --dist_* / COORDINATOR_ADDRESS) and pass make_mesh()")
    return mesh


def _check_cut(model: torch.nn.Module, mesh: Optional[Mesh]) -> None:
    """A step over a model axis needs the model cut over it."""
    if mesh is not None and mesh.shape["model"] > 1:
        cut = tensor_parallel(model)
        if cut is None or cut.shape != mesh.shape:
            raise ValueError(f"{mesh}: cut the model over the mesh's model axis first "
                             "(parallel/mesh.py::shard_model)")


def _dropout_rank(mesh: Optional[Mesh]) -> Optional[int]:
    return mesh.rank if mesh is not None and mesh.shape["data"] > 1 else None


def global_num_boxes(active: Optional[torch.Tensor], mesh: Optional[Mesh],
                     device: torch.device) -> torch.Tensor:
    """The batch's active-target count floored at 1, summed over the ranks
    under a data-parallel mesh (`active` None: a rank without rows)."""
    count = (torch.zeros((), device=device) if active is None
             else active.sum().float())
    if mesh is not None:
        distributed.all_reduce_sum_([count], mesh.data_group)
    return count.clamp(min=1.0)


# a rank's numbers for `reduce_stats`: the loss, the stats, then the matched
# targets of the class error and the rows
def _stat_row(loss, stats: Dict[str, torch.Tensor], active: torch.Tensor) -> torch.Tensor:
    return torch.stack([loss.detach().float(), *(v.detach().float() for v in stats.values()),
                        matched_targets(stats, active), torch.tensor(
                            float(active.shape[0]), device=active.device)])


_SUMMED_STATS = ("labels", "box_l1", "box_giou", "matcher_dropped")


def reduce_stats(rows: torch.Tensor, keys) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, stats) of one micro-batch over every rank's rows, from the
    (W, 3 + len(keys)) `_stat_row`s of the ranks: the loss and the
    loss-derived stats (over the global num_boxes) and the drop count add,
    the rounds take the max, the class error is recomputed over all matched
    targets, and the other stats (means over rows) are weighted by rows."""
    n, count = rows[:, -2], rows[:, -1]
    total_rows = count.sum().clamp(min=1.0)
    stats = {}
    for i, key in enumerate(keys, start=1):
        v = rows[:, i]
        if key in _SUMMED_STATS:
            stats[key] = v.sum()
        elif key == "matcher_rounds":
            stats[key] = v.max()
        elif key == "class_error":
            correct = torch.round((100.0 - v) / 100.0 * n).sum().long()
            stats[key] = 100.0 - 100.0 * correct / n.sum().long().clamp(min=1)
        else:
            stats[key] = (v * count).sum() / total_rows
    return rows[:, 0].sum(), stats


def _gather_rows(row: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(W, ...) of every data place's `row`, in order: an all-reduce over
    the data group of a zero block holding this rank's row (gloo gathers no
    CUDA tensors)."""
    out = row.new_zeros((mesh.shape["data"],) + tuple(row.shape))
    out[mesh.rank] = row
    distributed.all_reduce_sum_([out], mesh.data_group)
    return out


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
                    accum_steps: int = 1, mesh: Optional[Mesh] = None) -> Callable:
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
    is 1.0 then (else 0.0). The step counter advances either way.

    mesh: data and tensor parallelism over the ranks (module docstring).
    `data` is then this rank's contiguous block of the global batch (its
    data place's), and the loss and stats returned are the global batch's;
    the output and the mAP intermediaries are the rank's rows. With
    accumulation, micro-batch k of the global batch (rows k::K) is every
    rank's local rows k::K, which needs the block's rows divisible by K
    (raises ValueError with the sizes). Over a model axis the model must be
    cut over it (`parallel/mesh.py::shard_model`; ValueError otherwise)."""
    device = resolve_device(device)
    mesh = data_parallel(mesh)
    _check_cut(model, mesh)
    rank = _dropout_rank(mesh)
    params = list(optimizer.parameters())
    cut = sharded_params(model)
    axis = None if mesh is None else mesh.model_axis
    steps = [0]
    K = int(accum_steps)

    def loss_of(batch, num_boxes=None):
        fn = half_forward_and_loss if mixed_precision else forward_and_loss
        return fn(model, criterion_cfg, batch, num_boxes=num_boxes)

    def train_step(data: Dict[str, Any], seed: int):
        batch = to_device_batch(data, device)
        B = batch["active"].shape[0]
        if B % K:
            if mesh is not None:
                raise ValueError(
                    f"a rank's {B} rows of the global batch of {B * mesh.shape['data']} "
                    f"({mesh.shape['data']} ranks) are not divisible by accum_steps {K}")
            raise ValueError(f"batch {B} not divisible by accum_steps {K}")
        model.train()
        optimizer.zero_grad(set_to_none=True)
        num_boxes = global_num_boxes(batch["active"], mesh, device)
        split = {k: v for k, v in batch.items()
                 if torch.is_tensor(v) and v.ndim and v.shape[0] == B}
        loss, stats, outputs, rows = 0.0, None, [], []
        for k in range(K):
            micro = {**batch, **{key: v[k::K] for key, v in split.items()}}
            with seeded(seed, steps[0], device, micro=k if K > 1 else None, rank=rank):
                loss_k, (stats_k, logits_k, boxes_k) = loss_of(micro, num_boxes)
                loss_k.backward()
            if mesh is not None:  # reduced over the ranks after the last micro-batch
                rows.append(_stat_row(loss_k, stats_k, micro["active"]))
            else:
                loss = loss + loss_k.detach()
                stats = _combine_stats(stats, stats_k, K)
            outputs.append((logits_k.detach(), boxes_k.detach()))
        # micro-batch k's row j is row j*K + k of the batch
        pred_logits, pred_boxes = (torch.stack(list(out), 1).flatten(0, 1)
                                   for out in zip(*outputs))
        trained = [p for p in params if p.grad is not None]
        grads = [p.grad for p in trained]
        if mesh is not None:
            distributed.all_reduce_sum_(grads, mesh.data_group)
            gathered = _gather_rows(torch.stack(rows), mesh)  # (W, K, S)
            for k in range(K):
                loss_k, stats_k = reduce_stats(gathered[:, k], stats_k.keys())
                loss = loss + loss_k
                stats = _combine_stats(stats, stats_k, K)
        norm = global_norm(grads, [id(p) in cut for p in trained], axis)
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


def _eval_result(batch: Optional[Dict[str, torch.Tensor]], mesh: Optional[Mesh],
                 device: torch.device, loss_fn: Callable):
    """An eval step's (loss, stats, od_map_stuffs, output) from
    loss_fn(batch, num_boxes) -> (loss, (stats, pred_logits, pred_boxes)).
    Under a data-parallel mesh the count and the stats are the whole
    batch's, and a rank without rows (`batch` None) computes nothing and
    returns None for the mAP intermediaries and the output."""
    if batch is None and mesh is None:
        raise ValueError("an eval step without a mesh needs a batch")
    num_boxes = None if mesh is None else global_num_boxes(
        None if batch is None else batch["active"], mesh, device)
    output = od_map_stuffs = None
    if batch is not None:
        loss, (stats, pred_logits, pred_boxes) = loss_fn(batch, num_boxes)
        output, od_map_stuffs = postproc_and_map(pred_logits, pred_boxes, batch)
    if mesh is not None:
        row = (torch.zeros(3 + len(STAT_IDFS), device=device) if batch is None
               else _stat_row(loss, stats, batch["active"]))
        loss, stats = reduce_stats(_gather_rows(row, mesh), STAT_IDFS)
    return loss, stats, od_map_stuffs, output


def make_eval_step(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                   device: DeviceLike = None, mesh: Optional[Mesh] = None) -> Callable:
    """Returns eval_step(data) -> (loss, stats, od_map_stuffs, output): the
    forward in eval mode without autograd, the loss with every decoder
    level, post-processing and the mAP intermediaries. `data` is the JAX
    package's batch dict, moved to `device` (default CUDA; raises without a
    card), where the model must live.

    mesh: data and tensor parallelism over the ranks, as
    `make_train_step`'s. `data` is this rank's block of the batch, of any
    size (a ragged batch splits unevenly), or None for a rank without rows,
    which then returns None for the mAP intermediaries and the output; the
    loss and stats are the whole batch's on every rank."""
    device = resolve_device(device)
    mesh = data_parallel(mesh)
    _check_cut(model, mesh)

    def loss_fn(batch, num_boxes):
        return forward_and_loss(model, criterion_cfg, batch, num_boxes=num_boxes,
                                aux_levels=True)

    def eval_step(data: Optional[Dict[str, Any]]):
        model.eval()
        with torch.no_grad():
            return _eval_result(None if data is None else to_device_batch(data, device), mesh,
                                device, loss_fn)

    return eval_step


def make_host_matched_steps(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                            optimizer: Optional[AdamWClipped], mixed_precision: bool = False,
                            device: DeviceLike = None,
                            mesh: Optional[Mesh] = None) -> Tuple[Optional[Callable], Callable]:
    """Exact-matching train and eval steps (the JAX package's split around a
    host solve, for backends without host callbacks): `make_train_step` and
    an eval step with the criterion's matcher set to "hungarian", whatever
    `criterion_cfg.matcher` says, so every level is solved by the exact
    solver on the host between the forward and the loss. Eager torch calls
    the host inline, so one forward serves the costs and the loss (the JAX
    package runs it twice on one dropout stream).

    Returns (train_step, or None when `optimizer` is None, eval_step), with
    `make_train_step`'s and `make_eval_step`'s signatures and products. The
    train step keeps the non-finite guard on; `mixed_precision` runs both
    steps' forwards in bf16, as the JAX pair does. `mesh`: data parallelism
    over the ranks, as `make_eval_step`'s; each rank solves its own rows
    (the matching is per image, so the indices are the global solve's)."""
    device = resolve_device(device)
    mesh = data_parallel(mesh)
    _check_cut(model, mesh)
    exact = dataclasses.replace(criterion_cfg, matcher="hungarian")
    train_step = None if optimizer is None else make_train_step(
        model, exact, optimizer, skip_nonfinite=True, device=device,
        mixed_precision=mixed_precision, mesh=mesh)

    def loss_fn(batch, num_boxes):
        fn = half_forward_and_loss if mixed_precision else forward_and_loss
        return fn(model, exact, batch, num_boxes=num_boxes, aux_levels=True)

    def eval_step(data: Optional[Dict[str, Any]]):
        model.eval()
        with torch.no_grad():
            return _eval_result(None if data is None else to_device_batch(data, device), mesh,
                                device, loss_fn)

    return train_step, eval_step


def make_tracker_eval_step(model: torch.nn.Module, criterion_cfg: CriterionConfig, tracker,
                           host_matched: bool = False, device: DeviceLike = None,
                           mesh: Optional[Mesh] = None) -> Callable:
    """Returns eval_step(data) -> (loss, stats, od_map_stuffs, output) for
    the tracker baseline (`TrackerBaselineCore` at L >= 2), with
    `make_eval_step`'s signature: the per-frame detections of the past
    frames on `device` (default CUDA; raises without a card), the host-side
    `tracker` (models/tracker.py) on the last two of them as numpy, then the
    loss, post-processing and mAP intermediaries of its extrapolated future
    prediction back on the device. `host_matched=True` (the JAX package's
    split for backends without host callbacks) matches the prediction by
    the criterion's exact matcher on the host, whatever
    `criterion_cfg.matcher` says. `mesh`: as `make_eval_step`'s."""
    device = resolve_device(device)
    mesh = data_parallel(mesh)
    _check_cut(model, mesh)
    if host_matched:
        criterion_cfg = dataclasses.replace(criterion_cfg, matcher="hungarian")

    def loss_fn(batch, num_boxes):
        preds = model(batch)["per_frame_preds"]
        p0, p1 = ({k: p[k].float().cpu().numpy() for k in ("pred_logits", "pred_boxes")}
                  for p in preds[:2])
        offsets = batch.get("temporal_offsets")
        future = tracker(p0, p1, None if offsets is None else offsets.cpu().numpy())
        future = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
                  for k, v in future.items()}
        return loss_of_outputs(future, batch, criterion_cfg, num_boxes=num_boxes)

    def eval_step(data: Optional[Dict[str, Any]]):
        model.eval()
        with torch.no_grad():
            return _eval_result(None if data is None else to_device_batch(data, device), mesh,
                                device, loss_fn)

    return eval_step


def make_grad_report(model: torch.nn.Module, criterion_cfg: CriterionConfig,
                     device: DeviceLike = None, mesh: Optional[Mesh] = None) -> Callable:
    """Returns report(data, seed, step) -> {parameter name: the L2 norm of
    its gradient on `data`} (f32 scalars on `device`), from one forward in
    training mode with the dropout of train step `step` and one backward
    that leaves the parameters' `.grad` as it was. Frozen parameters
    (requires_grad False) and trainable ones the loss does not reach report
    0. The port of the JAX epoch-1 audit: under autograd a gradient that is
    identically zero on a real batch marks a dead branch or a mis-masked
    parameter, as the reference's `grad is None` check (trainer.py:181-185)
    does. With `mesh` (as `make_train_step`'s), `data` is the rank's block
    of the batch and the norms are those of the whole batch's gradient,
    summed over the data group; a cut parameter's norm is the whole
    parameter's (its shares' squares summed over the model group)."""
    device = resolve_device(device)
    mesh = data_parallel(mesh)
    _check_cut(model, mesh)
    rank = _dropout_rank(mesh)
    cut = sharded_params(model)

    def report(data: Dict[str, Any], seed: int, step: int) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(data, device)
        model.train()
        named = list(model.named_parameters())
        trainable = [p for _, p in named if p.requires_grad]
        with seeded(seed, step, device, rank=rank):
            num_boxes = global_num_boxes(batch["active"], mesh, device)
            loss, _ = forward_and_loss(model, criterion_cfg, batch, num_boxes=num_boxes)
            grads = list(torch.autograd.grad(loss, trainable, allow_unused=True))
        if mesh is not None:
            distributed.all_reduce_sum_([g for g in grads if g is not None], mesh.data_group)
        grads = iter(grads)
        squares = {}
        for name, p in named:
            g = next(grads) if p.requires_grad else None
            squares[name] = (torch.zeros((), device=device) if g is None
                             else g.float().square().sum())
        shares = [name for name, p in named if id(p) in cut]
        if shares:  # the cut parameters' squares, summed over the model group at once
            summed = distributed.all_reduce_sum(torch.stack([squares[n] for n in shares]),
                                                mesh.model_group)
            squares.update(zip(shares, summed))
        return {name: torch.sqrt(sq) for name, sq in squares.items()}

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
    CUDA; raises without a card), where the model must live. A static-int8
    model must be calibrated first (`calibrate_int8`; else ValueError)."""
    device = resolve_device(device)
    assert_calibrated(model)
    program = InferenceProgram(model.eval()).eval()

    def infer(data: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        batch = to_device_batch(data, device)
        with torch.inference_mode():
            return program(batch)

    return infer


def calibrate_int8(model: torch.nn.Module, batches, device: DeviceLike = None):
    """Calibrate a static-int8 model (`int8_static`) on `batches` (batch
    dicts, as `make_inference_fn`'s infer takes them): each forward runs the
    dynamic int8 path and raises every range to the running max of its
    convolution's input (`models/resnet.py::int8_calibration`, the JAX
    package's mutable-"quant" apply). Returns the model."""
    device = resolve_device(device)
    program = InferenceProgram(model.eval()).eval()
    with int8_calibration(model), torch.inference_mode():
        for data in batches:
            program(to_device_batch(data, device))
    return model
