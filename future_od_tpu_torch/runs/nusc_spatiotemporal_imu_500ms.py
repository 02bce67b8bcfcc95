"""The flagship's run: nuScenes spatiotemporal + IMU, 500 ms horizon (port of
runs/nusc_spatiotemporal_imu_500ms.py), on one CUDA card.

A two-stage resolution curriculum: stage 1 at (448, 800), batch 32, to 60 %
of the epochs; stage 2 at (896, 1600), batch 16, to the end. Offsets
[-1.0, -0.5, 0] s. Run it as a module from the repo root, e.g.

    python -m future_od_tpu_torch.runs.nusc_spatiotemporal_imu_500ms \\
        --synthetic --debug --disable_wandb --epochs 2

Without a card it exits with `utils/device.py::resolve_device`'s error.
"""
import os

from future_od_tpu_torch.data import nu_scenes
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.runs._helper import build_base_parser, get_lr_func, get_trainer
from future_od_tpu_torch.runs._loader import get_nusc_loaders
from future_od_tpu_torch.runs._model import build_model
from future_od_tpu_torch.runs.config import config

OFFSETS = [-1.0, -0.5, 0]


def train(model, args, detr_args):
    """Both stages; returns the Trainer."""
    lr_func = get_lr_func(args.epochs)
    print("starting dataset loading...")
    train_loader, val_loaders = get_nusc_loaders(
        (448, 800), offsets=OFFSETS, config=config, args=args, train_batch_size=32
    )
    trainer = get_trainer(args, config, detr_args, lr_func, model, train_loader, val_loaders)

    print("Starting first training stage")
    trainer.train(int(args.epochs * 0.60))

    print("Starting second training stage")
    trainer._train_loader, trainer._val_loaders = get_nusc_loaders(
        (896, 1600), offsets=OFFSETS, config=config, args=args, train_batch_size=16
    )
    trainer.train(args.epochs)
    return trainer


def build_parser():
    parser = build_base_parser()
    parser.add_argument("--epochs", default=160, type=int)
    return parser


def main(argv=None):
    """Parse `argv` (default: the command line), build the flagship and
    train it; returns the Trainer."""
    print(f"Started script: {os.path.basename(__file__)}")
    args = build_parser().parse_args(argv)
    args.experiment_idf = os.path.splitext(os.path.basename(__file__))[0]
    detr_args = SpatioTemporalDETRArgs(
        num_classes=len(nu_scenes.CATEGORY_DICT),
        num_queries=128,
        lr_backbone=1e-4,
        matcher=args.matcher,
        cost_slots=args.cost_slots,
        space_to_depth=args.s2d,
    )
    model = build_model(args, detr_args)
    print("built model")
    return train(model, args, detr_args)


if __name__ == "__main__":
    main()
