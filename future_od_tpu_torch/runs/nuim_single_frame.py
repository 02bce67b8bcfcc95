"""Single-frame ConditionalDETR-R50 detection on nuImages (port of
runs/nuim_single_frame.py), on one CUDA card: `build_single_frame` without
the IMU, one frame (offset 0), 448x800 at batch 32, one stage. `--debug`
takes hidden 64, 4 heads, 2+2 layers, 16 queries, 128x192 and batch 2,
as the JAX script does; `--synthetic` needs no data. Its final checkpoint is
the tracker baseline's detector (runs/eval/nusc_tracker_baseline_eval.py).
Run it as a module from the repo root.
"""
import os

from future_od_tpu_torch.data import nu_images
from future_od_tpu_torch.models.build import build_single_frame
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.runs._helper import (
    build_base_parser,
    get_lr_func,
    get_trainer,
    start_run,
)
from future_od_tpu_torch.runs._loader import get_nuim_loaders
from future_od_tpu_torch.runs.config import config

OFFSETS = [0]
IMAGE_SIZE, BATCH = (448, 800), 32
DEBUG_IMAGE_SIZE, DEBUG_BATCH = (128, 192), 2


def build_parser():
    parser = build_base_parser()
    parser.add_argument("--epochs", default=100, type=int)
    return parser


def detr_args_for(args) -> SpatioTemporalDETRArgs:
    """The script's model: 128 queries at full width, the debug widths
    under --debug; 2 classes on the synthetic data."""
    num_classes = 2 if args.synthetic else len(nu_images.CATEGORY_DICT)
    common = dict(num_classes=num_classes, lr_backbone=1e-4, matcher=args.matcher,
                  cost_slots=args.cost_slots, space_to_depth=args.s2d)
    if args.debug:
        return SpatioTemporalDETRArgs(num_queries=16, hidden_dim=64, enc_layers=2, dec_layers=2,
                                      dim_feedforward=128, enc_nheads=4, nheads=4, **common)
    return SpatioTemporalDETRArgs(num_queries=128, **common)


def main(argv=None):
    """Parse `argv` (default: the command line), build the single-frame
    model and train it; returns the Trainer."""
    print(f"Started script: {os.path.basename(__file__)}")
    args = build_parser().parse_args(argv)
    start_run(args)
    args.experiment_idf = os.path.splitext(os.path.basename(__file__))[0]
    detr_args = detr_args_for(args)
    model = build_single_frame(detr_args, use_imu=False)
    print("built model")
    print("starting dataset loading...")
    train_loader, val_loaders = get_nuim_loaders(
        DEBUG_IMAGE_SIZE if args.debug else IMAGE_SIZE, offsets=OFFSETS, config=config,
        args=args, train_batch_size=DEBUG_BATCH if args.debug else BATCH,
    )
    trainer = get_trainer(args, config, detr_args, get_lr_func(args.epochs), model,
                          train_loader, val_loaders)
    trainer.train(args.epochs)
    return trainer


if __name__ == "__main__":
    main()
