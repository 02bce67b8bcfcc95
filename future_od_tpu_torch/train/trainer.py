"""Epoch-based training and eval loop (port of future_od_tpu/train/trainer.py).

The operational surface of the JAX Trainer: the epoch loop, an eval epoch
per validation loader after each train epoch, AverageMeter stats per mode,
capped AP accumulation, the hardest-batch rule, the visualization schedule,
W&B, the epoch-1 gradient audit, checkpoint save and load, and the clean
exit on a signal. The model and the AdamW optimizer live on one device
(default CUDA; raises without a card), and the steps are
`train/step.py`'s.

The epoch loop runs one step ahead of its host bookkeeping: step i+1 is
queued on the device before step i's loss, stats and AP tensors are read
(each read a sync), so those reads overlap step i+1's device work.

Data parallelism (`mesh=`, `parallel/mesh.py::make_mesh()` under an
initialized process group): every rank runs this loop on its own card, its
loaders sharded to its rows (`data/loader.py`, `shard=(rank, world)`), and
the steps reduce over the ranks (`train/step.py`), so the meters are the
global batch's on every rank. The AP accumulators are gathered to the host
of every rank, step by step in rank order, so each row counts once and the
AP is the one-process run's. Rank 0 alone prints, logs to W&B, writes the
checkpoints (a barrier after each write) and draws the PNGs, from the
visualized batch and outputs gathered from every rank. A signal on any rank
stops every rank at the same step (the exit flag is reduced each step).
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from future_od_tpu_torch.data.loader import ARRAY_KEYS
from future_od_tpu_torch.metrics.od_map import aggregate_mean_average_precision
from future_od_tpu_torch.models.st_detr import STAT_IDFS, SpatioTemporalDETRArgs
from future_od_tpu_torch.parallel import distributed
from future_od_tpu_torch.train.optimizer import (
    build_optimizer,
    param_labels,
    set_learning_rates,
)
from future_od_tpu_torch.train.step import (
    data_parallel,
    dead_param_names,
    make_eval_step,
    make_grad_report,
    make_tracker_eval_step,
    make_train_step,
)
from future_od_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device
from future_od_tpu_torch.utils.signals import EXIT, install_signal_handlers
from future_od_tpu_torch.utils.stats import AverageMeter
from future_od_tpu_torch.utils.visualization import visualize, visualize_wandb
from future_od_tpu_torch.utils.wandb import WandBConfig, maybe_import_wandb

AP_IMAGE_CAP = 10_000  # accumulate AP stats from at most 10k images (trainer.py:203-204)


def _to_host(tree):
    """Tensors of a (nested) output dict -> numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy() if torch.is_tensor(tree) else tree


class Trainer:
    """The JAX Trainer's arguments, with `device` in place of the JAX
    package's device placement and `seed` seeding the dropout of every step
    (`train/step.py::step_seed`). `mixed_precision` and `accum_steps` go to
    the train step (`train/step.py::make_train_step`); eval stays f32, as
    the JAX Trainer's does. With a `tracker` (models/tracker.py) the eval
    step is the tracker baseline's (`train/step.py::make_tracker_eval_step`).
    `mesh`: data parallelism over the ranks (module docstring); `device`
    then defaults to the rank's card."""

    def __init__(
        self,
        model: torch.nn.Module,
        detr_args: SpatioTemporalDETRArgs,
        train_loader,
        val_loaders,
        checkpoint_path: str,
        visualization_path: str,
        save_name: str,
        category_dict: Dict[int, str],
        lr_func: Optional[Callable[[int], float]] = None,
        print_interval: int = 25,
        visualization_epochs=(),
        visualization_iterations=(0,),
        checkpoint_epochs: bool = True,
        wandb_config: Optional[WandBConfig] = None,
        matching_mode: str = "per level",
        mesh=None,
        seed: int = 0,
        mixed_precision: bool = False,
        checkpoint_every_iters: int = 0,
        freeze_backbone_stem: bool = True,
        tracker=None,
        accum_steps: int = 1,
        device: DeviceLike = None,
    ):
        self._mesh = data_parallel(mesh)
        if self._mesh is not None and device is None:
            device = self._mesh.local_device
        self._main = self._mesh is None or self._mesh.rank == 0
        self._device = resolve_device(device)
        install_signal_handlers()
        self._model = model.to(self._device)
        self._args = detr_args
        self._criterion_cfg = detr_args.criterion_config(matching_mode)
        self._train_loader = train_loader
        self._val_loaders = (
            {f"val{idx}": ldr for idx, ldr in enumerate(val_loaders)}
            if isinstance(val_loaders, (list, tuple))
            else dict(val_loaders)
        )
        if self._train_loader is not None and len(self._train_loader) == 0:
            raise ValueError("All loaders must be non-empty")
        if not all(len(ldr) > 0 for ldr in self._val_loaders.values()):
            raise ValueError("All loaders must be non-empty")

        self._checkpoint_path = checkpoint_path
        self._visualization_path = visualization_path
        self._save_name = save_name
        self._category_dict = category_dict
        self._lr_func = lr_func or (lambda e: 1.0)
        self._print_interval = print_interval
        self._visualization_epochs = set(visualization_epochs)
        self._visualization_iterations = set(visualization_iterations)
        self._save_checkpoints = checkpoint_epochs
        self._checkpoint_every_iters = checkpoint_every_iters
        self._wandb_config = wandb_config or WandBConfig()
        self._seed = seed
        self._freeze_stem = freeze_backbone_stem
        if getattr(detr_args, "freeze_stem", None) is not None and (
            detr_args.freeze_stem != freeze_backbone_stem
        ):
            # a disagreement is silently wrong one way: the model keeps
            # stem/layer1 out of autograd while the optimizer believes it
            # trains them
            raise ValueError(
                "Trainer(freeze_backbone_stem="
                f"{freeze_backbone_stem}) disagrees with "
                f"SpatioTemporalDETRArgs.freeze_stem={detr_args.freeze_stem};"
                " set both flags the same way"
            )
        self._grad_report = None  # built by the first _grad_audit
        self._dropped_warned = False  # one-shot cost_slots overflow warning
        self._last_ap = None  # the AP of the latest epoch of any mode
        # the AP of each mode's latest epoch; a mode that never aggregated
        # gives a KeyError naming it
        self._ap_by_mode: Dict[str, Any] = {}

        # stats meters per (mode, stat key) (trainer.py:71-77), with the
        # matcher's telemetry
        self._stat_idfs = STAT_IDFS
        self._stats: Dict[str, AverageMeter] = {}
        for mode in ["train"] + list(self._val_loaders.keys()):
            for key in self._stat_idfs:
                self._stats[f"{mode} {key} loss"] = AverageMeter()
        # the train step's divergence guard (step.py, skip_nonfinite)
        self._stats["train nonfinite_skipped loss"] = AverageMeter()
        self._nonfinite_warned = False

        self._epoch = 0
        self._training_iterations = 0
        self._wandb = None
        self._wandb_on = False  # W&B on for this run (every rank; rank 0 logs)

        self._optimizer = build_optimizer(
            self._model, lr=detr_args.lr, lr_backbone=detr_args.lr_backbone,
            weight_decay=detr_args.weight_decay, max_norm=detr_args.max_norm,
            freeze_stem=freeze_backbone_stem,
        )
        self._train_step = make_train_step(
            self._model, self._criterion_cfg, self._optimizer, device=self._device,
            mixed_precision=mixed_precision, accum_steps=accum_steps, mesh=self._mesh,
        )
        if tracker is None:
            self._eval_step = make_eval_step(self._model, self._criterion_cfg,
                                             device=self._device, mesh=self._mesh)
        else:
            # the non-learned tracker baseline: the host-side tracker runs
            # between the detections and the loss
            self._eval_step = make_tracker_eval_step(self._model, self._criterion_cfg, tracker,
                                                     device=self._device, mesh=self._mesh)

    @property
    def step(self) -> int:
        """Train steps taken (the JAX TrainState's `step`): seeds the next
        step's dropout."""
        return self._train_step.steps[0]

    # ------------------------------------------------------------------
    def _print(self, *args, **kwargs):
        if self._main:
            print(*args, **kwargs)

    def _exit_requested(self) -> bool:
        """The exit flag, on every rank alike: a rank that stopped alone
        would leave the others waiting in the next collective."""
        return EXIT.is_set() if self._mesh is None else distributed.any_rank(EXIT.is_set())

    def _barrier(self):
        if self._mesh is not None:
            distributed.barrier()

    def _check_sharded(self, data_loader, training: bool):
        """Under a mesh, a loader must give this rank its rows, and a train
        batch must split evenly over the ranks."""
        if self._mesh is None:
            return
        ranks = self._mesh.shape["data"]
        want = (self._mesh.rank, ranks)
        if getattr(data_loader, "shard", None) != want:
            raise ValueError(f"a data-parallel Trainer's loaders must load this rank's rows: "
                             f"shard={want} (Loader(shard=...)), got "
                             f"{getattr(data_loader, 'shard', None)}")
        if training and data_loader.batch_size % ranks:
            raise ValueError(f"the train batch of {data_loader.batch_size} does not split "
                             f"evenly over {ranks} ranks")

    # ------------------------------------------------------------------
    def train(self, max_epochs: int):
        self._setup_wandb(tags=["training"])
        self._print(f"Training epochs {self._epoch + 1} to {max_epochs}.")
        for epoch in range(self._epoch + 1, max_epochs + 1):
            self._epoch = epoch
            self._train_loader.set_epoch(epoch)
            factor = self._lr_func(epoch - 1)
            set_learning_rates(self._optimizer, self._args.lr * factor,
                               self._args.lr_backbone * factor)
            self._print(f"Starting epoch {epoch} with lr factor {factor}")
            self._run_epoch("train", self._train_loader, training=True)
            self._run_eval()
            for meter in self._stats.values():
                meter.new_epoch()
            if self._exit_requested():
                return
            if self._save_checkpoints:
                self._print("Saving Checkpoint")
                self.save_checkpoint(is_final=(epoch == max_epochs))
        self._print("Finished training!")

    def eval(self):
        self._setup_wandb(tags=["eval"])
        self._print("Running eval.")
        self._run_eval()

    def _run_eval(self):
        for name, loader in self._val_loaders.items():
            self._run_epoch(name, loader, training=False)

    # ------------------------------------------------------------------
    def _setup_wandb(self, tags=None):
        conf = self._wandb_config
        if not conf.enabled:
            return
        wandb = maybe_import_wandb()
        if wandb is None:
            self._print("wandb not installed; disabling W&B logging")
            self._wandb_config.enabled = False
            return
        self._wandb_on = True
        if not self._main:
            return
        wandb.init(
            project=conf.project,
            entity=conf.entity,
            config=conf.hyperparams,
            name=conf.name,
            notes=conf.notes,
            resume="must" if conf.resume_id else None,
            id=conf.resume_id,
            tags=tags,
        )
        self._wandb = wandb

    # ------------------------------------------------------------------
    def _grad_audit(self, data):
        """The epoch-1 dead-branch audit, and gradient watching.

        Prints every trainable parameter whose gradient is identically zero
        on the first batch (the reference prints its `grad is None`
        parameters, trainer.py:181-185); with wandb's watch_model, also logs
        each parameter's gradient norm every epoch. One forward and backward
        with the next train step's dropout; the parameters' `.grad` and the
        optimizer are left as they were.
        """
        if self._grad_report is None:
            # the auction, as the JAX Trainer's audit takes it: the audit is
            # about the gradient's reach, not the assignment
            cfg = dataclasses.replace(self._criterion_cfg, matcher="auction")
            self._grad_report = make_grad_report(self._model, cfg, device=self._device,
                                                 mesh=self._mesh)
        norms = self._grad_report(data, self._seed, self.step)
        if self._epoch == 1:
            labels = param_labels(self._model, self._freeze_stem)
            for name in dead_param_names(norms, labels):
                self._print(f"Parameter {name} has an identically-zero gradient")
        if (
            self._wandb_config.watch_model
            and self._wandb_config.enabled
            and self._wandb is not None
        ):
            self._wandb.log({"epoch": self._epoch,
                             **{f"grads/{name}": float(n) for name, n in norms.items()}})

    # ------------------------------------------------------------------
    def _run_epoch(self, mode: str, data_loader, training: bool):
        self._check_sharded(data_loader, training)
        num_iterations = len(data_loader)
        od_map_steps = []  # (step, its mAP intermediaries) of this rank's rows
        hardest = {"loss": -1e10, "data": None, "output": None}
        batch_size = data_loader.batch_size
        stats_keys = list(self._stat_idfs)
        t_start = time.time()

        def consume(i, batch, loss, stats, od_map_stuffs, output):
            # Host bookkeeping of step i. It runs after step i+1 is queued
            # (the one-step lag), so its reads overlap step i+1's device work.
            ap_collect = i * batch_size < AP_IMAGE_CAP
            # one device-to-host copy for the loss and every stat
            values = torch.stack([loss.float(), *(v.float() for v in stats.values())]).tolist()
            loss, stats = values[0], dict(zip(stats, values[1:]))
            for key, value in stats.items():
                self._stats[f"{mode} {key} loss"].update(value, 1)
            if stats.get("nonfinite_skipped", 0.0) > 0 and not self._nonfinite_warned:
                self._nonfinite_warned = True
                self._print(
                    "WARNING: a training step produced non-finite gradients; "
                    "its update was SKIPPED (divergence guard, train/step.py "
                    "skip_nonfinite). Telemetry: 'nonfinite_skipped' stat. "
                    "Recurring skips mean the run is unstable: lower the lr "
                    "or the batch size."
                )
            if stats.get("matcher_dropped", 0.0) > 0 and not self._dropped_warned:
                self._dropped_warned = True
                self._print(
                    f"WARNING: {stats['matcher_dropped']:.0f} active "
                    "targets exceeded cost_slots "
                    f"({self._criterion_cfg.cost_slots}) this step and were "
                    "dropped from matching/loss: raise "
                    "SpatioTemporalDETRArgs.cost_slots (--cost_slots) if this "
                    "recurs (telemetry: 'matcher_dropped' stat)."
                )
            if ap_collect and od_map_stuffs is not None:
                od_map_steps.append((i, [elem.cpu().numpy() for elem in od_map_stuffs]))

            # only the W&B visualization reads the hardest batch: without it,
            # copy no prediction and keep no batch for the epoch
            if (
                loss > hardest["loss"]
                and self._wandb_on
                and self._epoch in self._visualization_epochs
            ):
                hardest.update(loss=loss, data=batch, output=_to_host(output))

            if (
                i in self._visualization_iterations
                and self._epoch in self._visualization_epochs
            ):
                self.visualize_batch(batch, _to_host(output), mode)
            if (i + 1) % self._print_interval == 0:
                loss_str = "  ".join(
                    f"{self._stats[f'{mode} {k} loss'].avg:.5f} ({k})"
                    for k in stats_keys
                )
                self._print(
                    f"[{mode}: {self._epoch}, {i + 1:4d}/{num_iterations}] Loss: {loss_str}.")

        pending = None
        for i, batch in enumerate(data_loader):
            if self._exit_requested():
                if pending is not None:
                    consume(*pending)
                return
            # None: this rank's block of a ragged eval batch is empty
            data = None if batch is None else {k: v for k, v in batch.items()
                                               if k in ARRAY_KEYS}

            if training:
                if i == 0 and (self._epoch == 1 or self._wandb_config.watch_model):
                    self._grad_audit(data)
                loss, stats, od_map_stuffs, output = self._train_step(data, self._seed)
                self._training_iterations += 1
            else:
                loss, stats, od_map_stuffs, output = self._eval_step(data)

            if pending is not None:
                consume(*pending)
            pending = (i, batch, loss, stats, od_map_stuffs, output)

            if (
                training
                and self._checkpoint_every_iters
                and self._training_iterations % self._checkpoint_every_iters == 0
                and self._save_checkpoints
            ):
                # a mid-epoch checkpoint survives the preemption of a long
                # epoch; a resume restarts the epoch, as the reference does
                self.save_checkpoint()
        if pending is not None:
            consume(*pending)

        loss_items = [(self._stats[f"{mode} {k} loss"].avg, k) for k in stats_keys]
        loss_str = "  ".join(f"{v:.5f} ({k})" for v, k in loss_items)
        dt = time.time() - t_start
        self._print(f"[{mode}: {self._epoch}] Loss: {loss_str}  ({dt:.1f}s)")

        if self._mesh is not None:
            # every rank's steps, each step's blocks in rank order: the rows
            # in the order of the one-process run
            od_map_steps = [entry for _, entry in sorted(
                ((i, r), entry) for r, steps in enumerate(
                    distributed.all_gather_objects(od_map_steps)) for i, entry in steps)]
        else:
            od_map_steps = [entry for _, entry in od_map_steps]
        if not od_map_steps:
            return
        confs, is_positive, size_cats, num_annos = zip(*od_map_steps)
        ap = aggregate_mean_average_precision(
            np.concatenate(confs, axis=2),
            np.concatenate(is_positive, axis=2),
            np.concatenate(size_cats, axis=2),
            np.stack(num_annos, axis=2),
        )
        self._last_ap = ap
        self._ap_by_mode[mode] = ap
        self._print("AP50 for epoch is:", " ".join(f"{v:.3f}" for v in ap["all"][0, :, 0]))
        self._print("MAP for epoch is:", " ".join(f"{v:.3f}" for v in ap["threshavg"][:, 0]))
        for size_idx, size in [(1, "small"), (2, "medium"), (3, "large")]:
            self._print(
                f"MAP for {size} objects is:",
                " ".join(f"{v:.3f}" for v in ap["threshavg"][:, size_idx]),
            )

        if self._wandb_config.enabled and self._wandb is not None:
            log = {"epoch": self._epoch, "iteration": self._training_iterations}
            for style in ["classavg", "generic"]:
                for size_idx, size in enumerate(["", "-small", "-medium", "-large"]):
                    log[f"{mode}-{style}/ap{size}"] = ap[f"{style} threshavg"][size_idx]
                    log[f"{mode}-{style}/ap50{size}"] = ap[style][0, size_idx]
                    log[f"{mode}-{style}/ap70{size}"] = ap[style][4, size_idx]
            for class_idx, class_name in enumerate(self._category_dict.values()):
                log[f"{mode}-class/ap_{class_name}"] = ap["threshavg"][class_idx, 0]
                log[f"{mode}-class/ap50_{class_name}"] = ap["all"][0, class_idx, 0]
                log[f"{mode}-class/ap70_{class_name}"] = ap["all"][4, class_idx, 0]
            for val, name in loss_items:
                log[f"{mode}-losses/{name}"] = val
            self._wandb.log(log)
        if (self._wandb_on and self._epoch in self._visualization_epochs
                and hardest["loss"] > -1e10):
            self.visualize_batch(hardest["data"], hardest["output"], mode, prefix="hardest_")

    # ------------------------------------------------------------------
    def flush_saves(self):
        """Kept for the JAX Trainer's callers: saves here are durable when
        `save_checkpoint` returns, so there is nothing to wait for."""

    def save_checkpoint(self, is_final: bool = False):
        """Write <save_name> (the reference's dict, trainer.py:282-299: epoch,
        net_type, net, optimizer, lr_schedule, stats, device; with the run's
        detr_args and train step) and, when is_final, <save_name>_final (the
        net with net_type and detr_args). Durable on return. Under a mesh,
        rank 0 writes (every rank holds the same state) and every rank waits
        for the write."""
        if self._main:
            self._write_checkpoint(is_final)
        self._barrier()

    def _write_checkpoint(self, is_final: bool):
        net_type = type(self._model).__name__
        detr_args = dataclasses.asdict(self._args)
        save_checkpoint(self._checkpoint_path, self._save_name, {
            "epoch": self._epoch,
            "net_type": net_type,
            "net": self._model.state_dict(),
            "optimizer": self._optimizer.state_dict(),
            "lr_schedule": {"last_epoch": self._epoch,
                            "factor": self._lr_func(max(self._epoch - 1, 0))},
            "stats": {k: m.state_dict() for k, m in self._stats.items()},
            "device": str(self._device),
            "detr_args": detr_args,
            "step": self.step,
        })
        if is_final:
            save_checkpoint(self._checkpoint_path, self._save_name + "_final", {
                "net": self._model.state_dict(), "net_type": net_type, "detr_args": detr_args,
            })

    def load_checkpoint(self, checkpoint: Optional[str] = None, load_only_net=False,
                        trust_pickle=False):
        """checkpoint: None -> <checkpoint_path>/<save_name>; a path -> that
        file. A path ending in .pth or .pth.tar is a reference checkpoint: its
        `net` (or the file itself, a bare state_dict) loads into the model as
        it is, since the port's parameter names are the reference's keys;
        only the net. Such a file is unpickled as tensors and plain values
        only; one that holds other objects (the reference pickles its stat
        meters) raises unless `trust_pickle`, since unpickling can run code."""
        if checkpoint is not None and checkpoint.endswith((".pth", ".pth.tar")):
            path = os.path.expanduser(checkpoint)
            self._print(f"Loading reference checkpoint: {path}")
            blob = _load_reference(path, trust_pickle)
            state_dict = blob["net"] if isinstance(blob, dict) and "net" in blob else blob
            self._model.load_state_dict(state_dict, strict=True)
            self._print(f"Loaded: {path}")
            return
        if checkpoint is None:
            ckpt_dir, name = self._checkpoint_path, self._save_name
        else:
            path = os.path.expanduser(checkpoint)
            ckpt_dir, name = os.path.dirname(path) or ".", os.path.basename(path)
        self._print(f"Loading checkpoint: {os.path.join(ckpt_dir, name)}")
        # on the CPU: load_state_dict copies each tensor to its parameter's
        # device, and AdamW's step counts stay on the CPU, as a fresh
        # optimizer keeps them (on the card each step would read them back)
        blob = load_checkpoint(ckpt_dir, name, map_location="cpu")
        if blob is None:
            self._print(
                "WARNING: Attempted to load checkpoint, but it does not exist. "
                "Continuing without loading."
            )
            return
        if blob.get("net_type") != type(self._model).__name__:
            raise ValueError(f"checkpoint holds a {blob.get('net_type')}, this run a "
                             f"{type(self._model).__name__}")
        if blob.get("detr_args"):
            # behavioural flags without parameters load cleanly from another
            # config but change what the model computes: say so loudly
            ours = dataclasses.asdict(self._args)
            for key in ("encode_offset", "no_imu_speed", "space_to_depth"):
                saved = blob["detr_args"].get(key)
                if saved is not None and saved != ours.get(key):
                    self._print(
                        f"WARNING: checkpoint was trained with {key}={saved} "
                        f"but this run uses {key}={ours.get(key)}: outputs "
                        "will be wrong unless this is intentional."
                    )
        self._model.load_state_dict(blob["net"], strict=True)
        if not load_only_net:
            self._optimizer.load_state_dict(blob["optimizer"])
            self._train_step.steps[0] = int(blob.get("step", 0))
            self._epoch = int(blob.get("epoch", 0))
            for key, meter_state in blob.get("stats", {}).items():
                if key in self._stats:
                    self._stats[key].load_state_dict(meter_state)
        self._print(f"Loaded: {os.path.join(ckpt_dir, name)}")

    # ------------------------------------------------------------------
    def visualize_batch(self, batch, output, mode: str, prefix: str = ""):
        """PNGs, and W&B box overlays (trainer.py:334-413). Under a mesh
        every rank calls it with its rows (None: none), and rank 0 draws
        the whole batch."""
        if self._mesh is not None:
            batch, output = _gathered(batch, output)
            if batch is None:
                return
        scores = np.asarray(output["class_scores"])  # (B, L_out, 1, M, C+1)
        boxes = np.asarray(output["boxes"])
        B, L_out = scores.shape[:2]
        video = np.asarray(batch["video"])
        L_in = video.shape[1]
        assert L_in == L_out or L_out == 1
        background = scores.shape[-1]
        anno_classes = np.asarray(batch["classes"]).copy()
        anno_active = np.asarray(batch["active"])
        anno_classes[anno_active == 0] = background
        anno_boxes = np.asarray(batch["boxes"])
        anno_frame = np.asarray(batch["annotated_frame_idx"])
        ignore_boxes = np.asarray(batch.get("ignore_boxes", np.zeros_like(anno_boxes)))

        wandb_images = []
        for b in range(min(B, max(4, self._wandb_config.num_images))):
            fpath = os.path.join(self._visualization_path, f"{prefix}{mode}_b{b}_anno.png")
            visualize(video[b, anno_frame[b]], anno_classes[b], anno_boxes[b], fpath, background)
            for l in range(L_in):
                has_anno = l == anno_frame[b]
                has_det = L_in == L_out or has_anno
                if not has_det:
                    continue
                l_det = l if L_out == L_in else 0
                if self._wandb_config.enabled and b < self._wandb_config.num_images:
                    img = visualize_wandb(
                        image=video[b, l],
                        pred_scores=scores[b, l_det, 0],
                        pred_boxes=boxes[b, l_det, 0],
                        background_class=background,
                        category_dict=self._category_dict,
                        anno_classes=anno_classes[b] if has_anno else None,
                        anno_boxes=anno_boxes[b] if has_anno else None,
                        ignore_boxes=ignore_boxes[b] if has_anno else None,
                    )
                    if img is not None:
                        wandb_images.append(img)
        if wandb_images and self._wandb is not None:
            self._wandb.log({
                f"visualization/{prefix}{mode}_bounding_boxes": wandb_images,
                "epoch": self._epoch,
            })


# the batch keys `visualize_batch` draws
_VISUALIZED_KEYS = ("video", "classes", "active", "boxes", "annotated_frame_idx", "ignore_boxes")


def _gathered(batch, output):
    """(batch, output) of every rank's rows, concatenated in rank order, on
    rank 0; (None, None) on the other ranks. A rank without rows sends None."""
    mine = None if batch is None else (
        {k: np.asarray(batch[k]) for k in _VISUALIZED_KEYS if k in batch},
        {k: np.asarray(v) for k, v in output.items()})
    parts = distributed.gather_objects_to_main(mine)
    if parts is None:
        return None, None
    parts = [p for p in parts if p is not None]
    return tuple({k: np.concatenate([p[j][k] for p in parts]) for k in parts[0][j]}
                 for j in range(2))


def _load_reference(path: str, trust_pickle: bool):
    """A reference checkpoint's contents: tensors and plain values only, or,
    with `trust_pickle`, whatever the file pickled."""
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:
        if not trust_pickle:
            raise ValueError(
                f"{path} holds objects beyond tensors and plain values, and unpickling them "
                "can run code: if the file is trusted, load it with "
                "Trainer.load_checkpoint(path, trust_pickle=True), or save its `net` alone"
            ) from e
    print(f"WARNING: unpickling every object of {path} (trust_pickle)")
    return torch.load(path, map_location="cpu", weights_only=False)
