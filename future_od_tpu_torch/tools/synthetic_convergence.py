"""Synthetic convergence (port of tools/synthetic_convergence.py): the
Trainer on the synthetic moving-box task (256 training and 64 validation
samples, single-frame model) until AP50 is clearly nonzero, then the final
per-class validation AP50: evidence that data -> matcher -> loss ->
optimizer -> AP all point the right way without a dataset. Resumes from
the checkpoint a previous run left in --out.

Run on the card:  python -m future_od_tpu_torch.tools.synthetic_convergence [--epochs 120]
On the CPU (tiny model, 64x96, 4 + 2 samples, 1 epoch):  ... --check --out DIR
"""
from __future__ import annotations

import argparse
import sys

from future_od_tpu_torch.data.loader import VAL_SEED, Loader
from future_od_tpu_torch.data.synthetic import CATEGORY_DICT
from future_od_tpu_torch.models.build import build_single_frame
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.train.trainer import Trainer
from future_od_tpu_torch.utils.wandb import WandBConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--epochs", type=int, default=120)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--samples", type=int, default=256)
    parser.add_argument("--out", default="checkpoints")
    conv.add_run_flags(parser)
    return parser


def make_trainer(args: argparse.Namespace) -> Trainer:
    check, device = args.check, conv.device_of(args)
    detr_args = conv.detr_args(check, lr=args.lr)
    model = build_single_frame(detr_args, use_imu=False, device=device)
    train_ds = conv.dataset(check, conv.CHECK_SAMPLES if check else args.samples, seed=1)
    val_ds = conv.dataset(check, conv.CHECK_VAL_SAMPLES if check else 64, seed=2)
    batch = conv.CHECK_BATCH if check else args.batch
    return Trainer(
        model=model,
        detr_args=detr_args,
        train_loader=Loader(train_ds, batch_size=batch, shuffle=True, num_workers=4),
        val_loaders={"val0": Loader(val_ds, batch_size=batch, seed=VAL_SEED, num_workers=4)},
        checkpoint_path=args.out,
        visualization_path="visualization/synthetic_convergence",
        save_name="synthetic_convergence",
        category_dict=CATEGORY_DICT,
        lr_func=lambda e: min(1.0, (e + 1) / 5),
        print_interval=1000,
        checkpoint_epochs=True,
        wandb_config=WandBConfig(enabled=False),
        freeze_backbone_stem=False,  # training from scratch
        device=device,
    )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    trainer = make_trainer(args)
    trainer.load_checkpoint()  # resume if a previous run left a checkpoint
    trainer.train(conv.CHECK_EPOCHS if args.check else args.epochs)
    print("FINAL val AP50 per class:", " ".join(f"{v:.3f}" for v in conv.ap50(trainer._last_ap)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
