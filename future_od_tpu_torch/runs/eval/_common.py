"""The eval runs' shared logic (port of runs/eval/_common.py): each eval
script supplies its dataset, offsets and default checkpoint (and, for the
tracker baseline, its model builder and tracker); the model is built, the
checkpoint's net loaded, and the Trainer's eval epoch run over the
validation split."""
from __future__ import annotations

import argparse
import os

from future_od_tpu_torch.data import nu_images, nu_scenes
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.runs import _model
from future_od_tpu_torch.runs._helper import add_tpu_args, get_trainer, start_run
from future_od_tpu_torch.runs._loader import get_nuim_loaders, get_nusc_loaders
from future_od_tpu_torch.runs.config import config
from future_od_tpu_torch.runs.eval.helpers import add_hardcoded_eval_args

EVAL_IMAGE_SIZE = (896, 1600)


def build_eval_parser():
    parser = argparse.ArgumentParser(
        description="Experiment runfile, you run experiments from this file"
    )
    parser.add_argument("--disable_wandb", action="store_true", default=False)
    parser.add_argument("--checkpoint", default=None, help="Override checkpoint to be loaded")
    parser.add_argument("--night", action="store_true", default=False)
    parser.add_argument("--synthetic", action="store_true", default=False)
    add_tpu_args(parser)
    return parser


def run_eval(script_file: str, dataset: str, offsets, default_checkpoint: str,
             encode_offset: bool = False, filter_offsets=None, img_size=None, argv=None,
             model_builder=None, tracker=None):
    """Parse `argv` (default: the command line) and evaluate the checkpoint
    on `dataset` ("nusc" or "nuim") at `offsets`; `model_builder(args,
    detr_args)` builds the model (default: the flagship) and `tracker`, if
    given, makes the eval step the tracker baseline's. Returns the
    Trainer."""
    print(f"Started script: {os.path.basename(script_file)}")
    args = build_eval_parser().parse_args(argv)
    start_run(args)
    add_hardcoded_eval_args(args, default_checkpoint)
    args.experiment_idf = os.path.splitext(os.path.basename(script_file))[0]
    img_size = img_size or EVAL_IMAGE_SIZE

    if dataset == "nusc":
        category_dict = nu_scenes.CATEGORY_DICT
        loaders = lambda: get_nusc_loaders(  # noqa: E731
            img_size, offsets=offsets, config=config, args=args,
            train_batch_size=8, filter_offsets=filter_offsets,
        )
    else:
        category_dict = nu_images.CATEGORY_DICT
        loaders = lambda: get_nuim_loaders(  # noqa: E731
            img_size, offsets=offsets, config=config, args=args, train_batch_size=8
        )

    detr_args = SpatioTemporalDETRArgs(
        num_classes=len(category_dict),
        num_queries=128,
        lr_backbone=1e-4,
        encode_offset=encode_offset,
        matcher=args.matcher,
        cost_slots=args.cost_slots,
        space_to_depth=args.s2d,
        int8_backbone=args.int8,
    )
    model = (model_builder or _model.build_model)(args, detr_args)
    print("built model")
    print("starting dataset loading...")
    train_loader, val_loaders = loaders()
    print("Running eval")
    trainer = get_trainer(args, config, detr_args, None, model, train_loader, val_loaders,
                          tracker=tracker)
    trainer.eval()
    return trainer
