"""Branched auction-vs-exact matcher drift at converged accuracy (port of
tools/matcher_drift_branched.py).

Phase 1 trains one base model (the auction, the production matcher) past
the onset of AP into checkpoints/drift_base, epoch by epoch: a progress line
an epoch, an early stop at a mean validation AP50 (--stop-val-ap), a resume
that checks the stop before training (the progress file is the durable
"base done at epoch k" marker, honoured only when the checkpoint is at or
past that epoch), and an abort when the parameters turn non-finite.
Phase 2 resumes that checkpoint twice and trains --branch-epochs more
epochs with the auction and with the exact solver (ops/native_lap.py) under
the same data order and dropout, and reports the per-epoch |dAP50| of the
converged region.

Run on the card:  python -m future_od_tpu_torch.tools.matcher_drift_branched [--base-only]
On the CPU (tiny model, 64x96, 2 base epochs and 1 a branch):  ... --check --ckpt-dir DIR
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

from future_od_tpu_torch.data.loader import VAL_SEED, Loader
from future_od_tpu_torch.data.synthetic import CATEGORY_DICT
from future_od_tpu_torch.models.build import build_single_frame
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.train.trainer import Trainer
from future_od_tpu_torch.utils.wandb import WandBConfig

CHECK_BASE_EPOCHS, CHECK_BRANCH_EPOCHS = 2, 1


def make_trainer(matcher: str, save_name: str, batch: int, samples: int,
                 checkpoint_dir: str, val_samples: int = 64, lr: float = 3e-4,
                 max_norm: float = 0.1, check: bool = False, device=None) -> Trainer:
    detr_args = conv.detr_args(check, lr=lr, max_norm=max_norm, matcher=matcher)
    model = build_single_frame(detr_args, use_imu=False, device=device)
    train_ds = conv.dataset(check, samples, seed=1)
    val_ds = conv.dataset(check, val_samples, seed=2)
    return Trainer(
        model=model,
        detr_args=detr_args,
        train_loader=Loader(train_ds, batch_size=batch, shuffle=True, num_workers=4),
        val_loaders={"val0": Loader(val_ds, batch_size=batch, seed=VAL_SEED, num_workers=4)},
        checkpoint_path=checkpoint_dir,
        visualization_path=f"visualization/{save_name}",
        save_name=save_name,
        category_dict=CATEGORY_DICT,
        lr_func=lambda e: min(1.0, (e + 1) / 5),
        print_interval=1000,
        checkpoint_epochs=True,
        wandb_config=WandBConfig(enabled=False),
        freeze_backbone_stem=False,
        seed=0,  # one init, dropout and data order for every arm
        device=device,
    )


def _last_base_record(progress_path):
    """The last matcher == "base" line of the progress file, or None."""
    last = None
    if os.path.exists(progress_path):
        with open(progress_path) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except (json.JSONDecodeError, ValueError):
                    continue
                if rec.get("matcher") == "base":
                    last = rec
    return last


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--base-epochs", type=int, default=230)
    parser.add_argument("--branch-epochs", type=int, default=40)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--samples", type=int, default=256)
    parser.add_argument("--val-samples", type=int, default=64)
    parser.add_argument("--ckpt-dir", default="checkpoints")
    parser.add_argument("--out", default="checkpoints/matcher_drift_branched.json")
    parser.add_argument("--progress", default="checkpoints/matcher_drift_branched.jsonl")
    parser.add_argument("--base-only", action="store_true",
                        help="stop after the base phase (stage the long base "
                             "run separately from the branch comparison)")
    parser.add_argument("--stop-val-ap", type=float, default=0.0,
                        help="end the base phase early once mean val AP50 "
                             "reaches this (0 = train the full --base-epochs)")
    conv.add_run_flags(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    device = conv.device_of(args)
    if args.check:
        args.base_epochs, args.branch_epochs = CHECK_BASE_EPOCHS, CHECK_BRANCH_EPOCHS
        args.samples, args.val_samples = conv.CHECK_SAMPLES, conv.CHECK_VAL_SAMPLES
        args.batch = conv.CHECK_BATCH
    os.makedirs(os.path.dirname(args.progress) or ".", exist_ok=True)

    def trainer_for(matcher, name):
        return make_trainer(matcher, name, args.batch, args.samples, args.ckpt_dir,
                            args.val_samples, check=args.check, device=device)

    # Phase 1: the base run (the auction) to past-onset AP, epoch by epoch
    base = trainer_for("auction", "drift_base")
    base.load_checkpoint()  # resume a partial base if one exists
    # on resume, the stop condition is checked before training: a second
    # invocation resuming a base that already stopped early must not train
    # more base epochs (that would move the branching point)
    prev = _last_base_record(args.progress)
    base_done = bool(
        args.stop_val_ap
        and prev is not None
        and float(np.nanmean(prev["ap50"])) >= args.stop_val_ap
        # ...and the resumed checkpoint is at or past that epoch: a progress
        # file without its checkpoint must not skip the base phase
        and base._epoch >= int(prev["epoch"])
    )
    if base_done:
        print(f"BASE already at mean val AP50 "
              f"{float(np.nanmean(prev['ap50'])):.3f} >= {args.stop_val_ap} "
              f"(progress epoch {prev['epoch']}, checkpoint epoch "
              f"{base._epoch}); skipping phase 1", flush=True)
    for e in ([] if base_done else range(base._epoch + 1, args.base_epochs + 1)):
        base.train(e)
        labels = base._stats["train labels loss"].history[-1]
        if not np.isfinite(labels):
            # the train step's non-finite guard keeps the old parameters on a
            # poisoned step, so a non-finite epoch mean is no dead run: abort
            # only when the parameters themselves are non-finite
            params_ok = all(bool(torch.isfinite(p).all()) for p in base._model.parameters())
            skipped = base._stats["train nonfinite_skipped loss"].history[-1]
            if not params_ok:
                sys.exit(f"ABORT: base run diverged (labels loss {labels} at "
                         f"epoch {e}, params non-finite); lower --batch/lr "
                         f"and clear --ckpt-dir")
            print(f"WARN: epoch {e} labels loss {labels} but params finite "
                  f"(guard skipped {skipped:.3f} of steps); continuing", flush=True)
        tr_ap = conv.ap50(base._ap_by_mode["train"])
        val_ap = conv.ap50(base._ap_by_mode["val0"])
        with open(args.progress, "a") as f:
            f.write(json.dumps({
                "matcher": "base", "epoch": e, "labels_loss": float(labels),
                "train_ap50": tr_ap, "ap50": val_ap,
            }) + "\n")
        if args.stop_val_ap and float(np.nanmean(val_ap)) >= args.stop_val_ap:
            print(f"BASE reached mean val AP50 "
                  f"{float(np.nanmean(val_ap)):.3f} >= {args.stop_val_ap} at "
                  f"epoch {e}; ending base phase", flush=True)
            break
    base_epochs = base._epoch  # early stop and resume aware
    # a fully resumed base trains no epoch, so its AP comes from the
    # progress file's last base line
    tr_ap_tbl = base._ap_by_mode.get("train")
    if tr_ap_tbl is not None:
        base_ap = conv.ap50(tr_ap_tbl)
    else:
        prev = _last_base_record(args.progress)
        base_ap = None if prev is None else prev.get("train_ap50")
    print(f"BASE train AP50 after {base_epochs} epochs: {base_ap}", flush=True)
    base.flush_saves()
    if args.base_only:
        print("--base-only: stopping after the base phase", flush=True)
        return 0
    base_ckpt = os.path.join(args.ckpt_dir, "drift_base")

    # Phase 2: both matcher arms from the base checkpoint (branches never
    # save, so both load the base checkpoint)
    results = {"base_ap50": base_ap, "base_epochs": base_epochs}
    total = base_epochs + args.branch_epochs
    for matcher in ("auction", "hungarian"):
        trainer = trainer_for(matcher, f"drift_branch_{matcher}")
        trainer._save_checkpoints = False
        trainer.load_checkpoint(base_ckpt)
        ap = {"train": [], "val": []}
        for e in range(base_epochs + 1, total + 1):
            trainer.train(e)
            ap["train"].append(conv.ap50(trainer._ap_by_mode["train"]))
            ap["val"].append(conv.ap50(trainer._ap_by_mode["val0"]))
            with open(args.progress, "a") as f:
                f.write(json.dumps({
                    "matcher": matcher, "epoch": e,
                    "train_ap50": ap["train"][-1], "ap50": ap["val"][-1],
                }) + "\n")
        results[matcher] = ap

    a = np.asarray(results["auction"]["train"])  # (E, C)
    h = np.asarray(results["hungarian"]["train"])
    av = np.asarray(results["auction"]["val"])
    hv = np.asarray(results["hungarian"]["val"])
    results["summary"] = {
        "branch_epochs": args.branch_epochs,
        # systematic drift: |window mean(auction) - window mean(exact)| per
        # class (per-epoch deltas measure run-to-run noise instead)
        "train_windowmean_ap50_delta": np.abs(np.nanmean(a, 0) - np.nanmean(h, 0)).tolist(),
        "val_windowmean_ap50_delta": np.abs(np.nanmean(av, 0) - np.nanmean(hv, 0)).tolist(),
        "val_windowmean_ap50": {
            "auction": np.nanmean(av, 0).tolist(),
            "hungarian": np.nanmean(hv, 0).tolist(),
        },
        "train_mean_ap50_abs_delta": float(np.nanmean(np.abs(a - h))),
        "train_max_ap50_abs_delta": float(np.nanmax(np.abs(a - h))),
        "train_final_ap50": {"auction": a[-1].tolist(), "hungarian": h[-1].tolist()},
        "val_mean_ap50_abs_delta": float(np.nanmean(np.abs(av - hv))),
        "val_max_ap50_abs_delta": float(np.nanmax(np.abs(av - hv))),
        "val_final_ap50": {"auction": av[-1].tolist(), "hungarian": hv[-1].tolist()},
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(results, f)
    print("BRANCHED DRIFT SUMMARY:", json.dumps(results["summary"], indent=2), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
