"""What the learning-loop tools share: the synthetic task's model config
and datasets (the JAX tools' `SpatioTemporalDETRArgs` and
`SyntheticClipDataset` arguments), the `--check` sizes, the device flags,
and the probes' loop over one fixed batch.

`--check` runs a tool on the CPU at a tiny size: a narrow transformer, 64x96
images, a few samples, steps and epochs. Without it a tool runs at the JAX
tool's size on the card (`--device` picks another device).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from future_od_tpu_torch.data.loader import ARRAY_KEYS, collate
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.metrics.od_map import aggregate_mean_average_precision
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.train.optimizer import build_optimizer
from future_od_tpu_torch.train.step import make_train_step, to_device_batch
from future_od_tpu_torch.utils.device import resolve_device

# the JAX tools' model: a from-scratch run backprops the whole trunk
MODEL = dict(freeze_stem=False, num_classes=2, num_queries=32, hidden_dim=128, enc_layers=2,
             dec_layers=3, dim_feedforward=512, enc_nheads=8, nheads=8)
IMAGE_SIZE = (128, 192)
LR = 3e-4
# --check
CHECK_MODEL = dict(MODEL, num_queries=8, hidden_dim=32, enc_layers=1, dec_layers=2,
                   dim_feedforward=64, enc_nheads=4, nheads=4)
CHECK_IMAGE_SIZE = (64, 96)
CHECK_SAMPLES = 4  # a training split's samples
CHECK_VAL_SAMPLES = 2
CHECK_BATCH = 2
CHECK_STEPS = 2
CHECK_EPOCHS = 1


def detr_args(check: bool, lr: float = LR, **extra) -> SpatioTemporalDETRArgs:
    """The tools' model config (`--check`: its tiny twin) with learning
    rate `lr` for the whole model and the JAX tool's `extra` fields."""
    return SpatioTemporalDETRArgs(**(CHECK_MODEL if check else MODEL), lr=lr, lr_backbone=lr,
                                  **extra)


def dataset(check: bool, num_samples: int, seed: int, num_frames: int = 1,
            max_objects: int = 4) -> SyntheticClipDataset:
    """A synthetic split at the tools' image size (`--check`: 64x96)."""
    return SyntheticClipDataset(num_samples=num_samples, num_frames=num_frames,
                                image_size=CHECK_IMAGE_SIZE if check else IMAGE_SIZE,
                                max_objects=max_objects, seed=seed)


def add_run_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--check", action="store_true",
                        help="run on the CPU at a tiny size, for a few steps")
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card; with --check, the CPU)")


def device_of(args: argparse.Namespace) -> Optional[str]:
    return "cpu" if args.check and args.device is None else args.device


def ap50(ap: Dict[str, np.ndarray]) -> List[float]:
    """Per-class AP50 of an AP dict (threshold 0.5, all sizes)."""
    return [float(v) for v in ap["all"][0, :, 0]]


def ap_record(ap: Dict[str, np.ndarray]) -> Dict[str, List[float]]:
    """The AP checks' per-split record: AP50 and mAP per class."""
    return {"ap50": ap50(ap), "map": [float(v) for v in np.nanmean(ap["all"][:, :, 0], axis=0)]}


def run_probe(model: torch.nn.Module, args: SpatioTemporalDETRArgs,
              ds: SyntheticClipDataset, steps: int, interval: int, device=None,
              seed: int = 1) -> dict:
    """The overfit probes' loop on `device` (default the card), where `model`
    lives: every sample of `ds` as one batch, AdamW at
    the model's learning rates with clip 0.1, steps 0..`steps` (inclusive,
    as the JAX probes count), and at every `interval`-th the JAX tools'
    line of the loss, its parts and the per-class AP50 of that step.
    Returns {"lines": one record a printed step, "losses": every step's
    loss, "step_ms": the median wall time of a step (the step reads its
    loss on the host, so each step ends on the device before the next)}."""
    device = resolve_device(device)
    batch = collate([ds[i] for i in range(len(ds))])
    data = to_device_batch({k: v for k, v in batch.items() if k in ARRAY_KEYS}, device)
    optimizer = build_optimizer(model, lr=args.lr, lr_backbone=args.lr_backbone,
                                max_norm=0.1, freeze_stem=False)
    step = make_train_step(model, args.criterion_config(), optimizer, device=device)
    lines, losses, times = [], [], []
    for it in range(steps + 1):
        start = time.perf_counter()
        loss, stats, odmap, _ = step(data, seed)
        losses.append(float(loss))
        times.append(time.perf_counter() - start)
        if it % interval == 0:
            s = {k: float(v) for k, v in stats.items()}
            ap = aggregate_mean_average_precision(
                *[x.cpu().numpy() for x in odmap[:3]], odmap[3].cpu().numpy()[..., None])
            lines.append({"it": it, "loss": losses[-1], "l1": s["box_l1"],
                          "giou": s["box_giou"], "labels": s["labels"], "ap50": ap50(ap)})
            print(f"it {it}: loss={losses[-1]:.3f} l1={s['box_l1']:.3f} "
                  f"giou={s['box_giou']:.3f} labels={s['labels']:.3f} "
                  f"AP50={np.round(ap['all'][0, :, 0], 3)}", flush=True)
    step_ms = 1e3 * float(np.median(times[1:] if len(times) > 1 else times))
    print(f"{steps + 1} steps: {step_ms:.2f} ms a step (median)", flush=True)
    return {"lines": lines, "losses": losses, "step_ms": step_ms}
