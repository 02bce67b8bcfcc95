"""AP of the int8 PTQ backbone on a trained model (port of
tools/quant_ap_check.py).

Loads the converged synthetic single-frame checkpoint that the branched
drift run's base phase writes (checkpoints/drift_base), runs the same
evaluation with the float and the int8 backbone (`int8_backbone`, whose
convolutions run on K8 and K9 on the card) over the training split ("fit",
where AP has converged) and the held-out one ("val0"), and reports each
arm's per-class AP50 and mAP and the per-class |dAP50| of each split.

Run on the card:  python -m future_od_tpu_torch.tools.quant_ap_check [--ckpt checkpoints/drift_base]
On the CPU (the tiny model of matcher_drift_branched --check):  ... --check --ckpt DIR/drift_base
"""
from __future__ import annotations

import argparse
import json
import os
import sys

from future_od_tpu_torch.data.loader import VAL_SEED, Loader
from future_od_tpu_torch.data.synthetic import CATEGORY_DICT
from future_od_tpu_torch.models.build import build_single_frame
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.train.trainer import Trainer
from future_od_tpu_torch.utils.wandb import WandBConfig

SPLITS = ("fit", "val0")


def make_trainer(int8: bool, ckpt: str, batch: int, check: bool = False, device=None,
                 visualization_path: str = "visualization/quant_ap_check") -> Trainer:
    """An evaluating Trainer of matcher_drift_branched's model (what the
    checkpoint holds) with the float or the int8 backbone, its checkpoint
    loaded, over the "fit" (the training split) and "val0" loaders."""
    detr_args = conv.detr_args(check, int8_backbone=int8)
    model = build_single_frame(detr_args, use_imu=False, device=device)
    # the training split: the held-out one sits near the AP noise floor on
    # this tiny task, so quantization deltas show only where AP converged
    fit_ds = conv.dataset(check, conv.CHECK_SAMPLES if check else 256, seed=1)
    val_ds = conv.dataset(check, conv.CHECK_VAL_SAMPLES if check else 64, seed=2)
    trainer = Trainer(
        model=model,
        detr_args=detr_args,
        train_loader=Loader(val_ds, batch_size=batch, num_workers=2),
        val_loaders={
            "fit": Loader(fit_ds, batch_size=batch, seed=VAL_SEED, num_workers=2),
            "val0": Loader(val_ds, batch_size=batch, seed=VAL_SEED, num_workers=2),
        },
        checkpoint_path=os.path.dirname(ckpt) or ".",
        visualization_path=visualization_path,
        save_name=os.path.basename(ckpt),
        category_dict=CATEGORY_DICT,
        print_interval=1000,
        wandb_config=WandBConfig(enabled=False),
        freeze_backbone_stem=False,  # as matcher_drift_branched trains: the
        # optimizer's state must match the checkpoint's
        seed=0,
        device=device,
    )
    trainer.load_checkpoint(ckpt)
    return trainer


def split_aps(trainer: Trainer) -> dict:
    return {mode: conv.ap_record(trainer._ap_by_mode[mode]) for mode in SPLITS}


def evaluate(int8: bool, ckpt: str, batch: int, check: bool = False, device=None) -> dict:
    trainer = make_trainer(int8, ckpt, batch, check, device)
    trainer._run_eval()
    return split_aps(trainer)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="checkpoints/drift_base")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--out", default="checkpoints/quant_ap_check.json")
    conv.add_run_flags(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    batch = conv.CHECK_BATCH if args.check else args.batch
    results = {}
    for name, int8 in (("float", False), ("int8", True)):
        results[name] = evaluate(int8, args.ckpt, batch, args.check, conv.device_of(args))
        print(name, results[name], flush=True)
    for mode in SPLITS:
        results[f"{mode}_ap50_abs_delta"] = [
            abs(a - b) for a, b in zip(results["float"][mode]["ap50"],
                                       results["int8"][mode]["ap50"])]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print(json.dumps(results, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
