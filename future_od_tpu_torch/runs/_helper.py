"""Shared run-script helpers (port of runs/_helper.py): the Trainer built
from loaders, model and arguments, the argument parser with the JAX scripts'
option strings, and the LR schedule.

A run is one process on one card, or one process a card joined into a
torch.distributed process group: by torchrun (`python -m torch.distributed.run
--nproc_per_node N -m future_od_tpu_torch.runs.<script>`), by the `--dist_*`
options, or by COORDINATOR_ADDRESS / NUM_PROCESSES / PROCESS_ID or SLURM
(`parallel/distributed.py`). Its ranks then train as one global-batch step
over a (data, model) mesh (`_build_mesh`): `--mesh_model M` cuts the
transformer's projections over M ranks of a host (tensor parallelism), the
data axis takes the rest. `--bf16` and `--accum` reach the
Trainer's train step; `--int8` builds the eval scripts' model with the int8
PTQ backbone (runs/eval/_common.py), as in the JAX package, and training
runs the float path.
`--prng` picks the JAX package's dropout generator, which torch's has no
counterpart for; it changes nothing here.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from future_od_tpu_torch.data import nu_images, nu_scenes, synthetic
from future_od_tpu_torch.parallel import distributed
from future_od_tpu_torch.parallel.mesh import make_mesh
from future_od_tpu_torch.train.optimizer import get_lr_func  # noqa: F401  (re-export)
from future_od_tpu_torch.train.trainer import Trainer
from future_od_tpu_torch.utils.wandb import WandBConfig


def category_dict_for(train_loader):
    ds = train_loader.dataset
    if isinstance(ds, synthetic.SyntheticClipDataset):
        return synthetic.CATEGORY_DICT
    if type(ds).__name__ == "NuImagesDataset":
        return nu_images.CATEGORY_DICT
    return nu_scenes.CATEGORY_DICT


def start_run(args) -> None:
    """Join the run's process group when there is one (before the model is
    built: each rank then builds it on its own card)."""
    distributed.maybe_initialize_distributed(args)


def _build_mesh(args):
    """The (data, model) mesh of this run's ranks, or None for one process:
    the model axis `--mesh_model`, within a host (the ranks a host runs must
    divide by it, `distributed.mesh_axes`), the data axis every rank it
    leaves. The JAX function clips the data axis to a divisor of the global
    batch; here the ranks are fixed by the launch, and the Trainer raises
    when the batch does not split. `--mesh_model` above 1 in one process
    raises ValueError: tensor parallelism runs one rank a device."""
    num_model = int(getattr(args, "mesh_model", 1))
    if not distributed.is_initialized():
        if num_model > 1:
            raise ValueError(f"--mesh_model {num_model} needs {num_model} ranks a model "
                             "replica: start one rank a device (torchrun, or --dist_*)")
        return None
    num_data, num_model = distributed.mesh_axes(distributed.world_size(),
                                                distributed.local_world_size(), num_model)
    mesh = make_mesh(num_data, num_model)
    if distributed.is_main_process():
        print(f"device mesh: data={num_data} model={num_model} "
              f"({distributed.world_size()} ranks)")
    return mesh


def get_trainer(args, config, detr_args, lr_func, model, train_loader, val_loaders,
                tracker=None):
    start_run(args)
    trainer = Trainer(
        model=model,
        detr_args=detr_args,
        mesh=_build_mesh(args),
        train_loader=train_loader,
        val_loaders=val_loaders,
        checkpoint_path=config["checkpoint_path"],
        visualization_path=os.path.join(config["visualization_path"], args.experiment_idf),
        save_name=args.experiment_idf,
        category_dict=category_dict_for(train_loader),
        lr_func=lr_func,
        print_interval=25,
        visualization_epochs=set(int(i) for i in np.linspace(1, args.epochs, 10)),
        visualization_iterations=[0],
        checkpoint_epochs=not args.no_checkpoints,
        mixed_precision=getattr(args, "bf16", False),
        checkpoint_every_iters=getattr(args, "checkpoint_every_iters", 0),
        accum_steps=getattr(args, "accum", 1),
        tracker=tracker,
        wandb_config=WandBConfig(
            enabled=(not args.disable_wandb),
            name=args.experiment_idf + getattr(args, "wandb_suffix", ""),
            notes="",
            num_images=32,
            hyperparams={
                "slurm-id": os.environ.get("SLURM_JOB_ID"),
                "epochs": args.epochs,
            },
            resume_id=args.wandb_resume_id,
        ),
    )
    if not args.restart:
        trainer.load_checkpoint(args.checkpoint, getattr(args, "load_only_net", False))
    return trainer


# the training scripts' two stages: (image size, train batch size)
STAGES = (((448, 800), 32), ((896, 1600), 16))


def two_stage_train(model, args, detr_args, config, get_loaders, offsets, lr_func):
    """The scripts' resolution curriculum (`STAGES`): stage 1 to 60 % of the
    epochs, stage 2 to the end. Returns the Trainer."""
    (size1, batch1), (size2, batch2) = STAGES
    print("starting dataset loading...")
    train_loader, val_loaders = get_loaders(
        size1, offsets=offsets, config=config, args=args, train_batch_size=batch1
    )
    trainer = get_trainer(args, config, detr_args, lr_func, model, train_loader, val_loaders)

    print("Starting first training stage")
    trainer.train(int(args.epochs * 0.60))

    print("Starting second training stage")
    trainer._train_loader, trainer._val_loaders = get_loaders(
        size2, offsets=offsets, config=config, args=args, train_batch_size=batch2
    )
    trainer.train(args.epochs)
    return trainer


def script_parser(epochs: int):
    parser = build_base_parser()
    parser.add_argument("--epochs", default=epochs, type=int)
    return parser


def run_script(script_file: str, argv, epochs: int, config, get_loaders, offsets,
               category_dict, lr_func=None, **detr_kw):
    """A training script's main(): parse `argv` (default: the command line),
    build the flagship for `category_dict`'s classes (with `detr_kw`) and
    train it in two stages on `get_loaders`' data at `offsets`, with
    `lr_func` (default `get_lr_func(epochs)`). Returns the Trainer."""
    from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
    from future_od_tpu_torch.runs._model import build_model

    print(f"Started script: {os.path.basename(script_file)}")
    args = script_parser(epochs).parse_args(argv)
    start_run(args)
    args.experiment_idf = os.path.splitext(os.path.basename(script_file))[0]
    detr_args = SpatioTemporalDETRArgs(
        num_classes=len(category_dict),
        num_queries=128,
        lr_backbone=1e-4,
        matcher=args.matcher,
        cost_slots=args.cost_slots,
        space_to_depth=args.s2d,
        **detr_kw,
    )
    model = build_model(args, detr_args)
    print("built model")
    return two_stage_train(model, args, detr_args, config, get_loaders, offsets,
                           lr_func or get_lr_func(args.epochs))


def build_base_parser():
    parser = argparse.ArgumentParser(
        description="Experiment runfile, you run experiments from this file"
    )
    parser.add_argument("--restart", action="store_true", default=False)
    parser.add_argument("--debug", action="store_true", default=False)
    parser.add_argument("--disable_wandb", action="store_true", default=False)
    parser.add_argument("--wandb_resume_id", default=None)
    parser.add_argument("--no_checkpoints", action="store_true", default=False)
    parser.add_argument("--checkpoint", default=None, help="Override checkpoint to be loaded")
    parser.add_argument("--short_train", action="store_true", default=False)
    parser.add_argument("--night", action="store_true", default=False)
    parser.add_argument("--load-only-net", action="store_true", default=False)
    parser.add_argument(
        "--synthetic", action="store_true", default=False,
        help="Use the synthetic moving-box dataset (no real data required)",
    )
    add_tpu_args(parser)
    return parser


def add_tpu_args(parser):
    """The JAX scripts' accelerator options, with the same strings; those
    the port does not honour yet say so in their help and raise when used."""
    parser.add_argument(
        "--mesh_model", default=1, type=int,
        help="tensor-parallel axis size; data axis = ranks / mesh_model",
    )
    parser.add_argument(
        "--matcher", default="auction", choices=["auction", "hungarian"],
        help="set-matching solver (auction = on the device, hungarian = exact, "
        "the C++ Jonker-Volgenant solver on the host)",
    )
    parser.add_argument(
        "--cost_slots", default=128, type=int,
        help="compact the dense Nmax=256 target slots to this many active "
        "slots before the matcher cost build / solve / loss (exact while "
        "every image has <= this many boxes; overflow is dropped loudly: "
        "'matcher_dropped' stat). 0 = no compaction",
    )
    parser.add_argument("--num_workers", default=16, type=int)
    parser.add_argument(
        "--s2d", action="store_true", default=False,
        help="space-to-depth stem with HOST-packed 12-channel frames "
        "(the loader packs each sample; see models/resnet.py)",
    )
    parser.add_argument(
        "--int8", action="store_true", default=False,
        help="int8 PTQ backbone for inference/eval (ops/quant.py; training "
        "steps always run the float path)",
    )
    parser.add_argument(
        "--loader", default="thread", choices=["thread", "grain"],
        help="input pipeline backend: the thread pool, or (grain) worker "
        "processes",
    )
    parser.add_argument(
        "--device_normalize", action="store_true", default=False,
        help="ship uint8 video and normalize on the device",
    )
    parser.add_argument(
        "--checkpoint_every_iters", default=0, type=int,
        help="also checkpoint mid-epoch every N train iterations (preemption safety)",
    )
    parser.add_argument(
        "--bf16", action="store_true", default=False,
        help="bfloat16 forward/backward with f32 master params",
    )
    parser.add_argument(
        "--accum", type=int, default=1,
        help="gradient-accumulation micro-steps (exact: the batch splits into "
        "this many micro-batches)",
    )
    parser.add_argument(
        "--prng", default="rbg", choices=["rbg", "threefry2x32"],
        help="the JAX package's dropout-bit PRNG; torch's generator has no "
        "counterpart, so it changes nothing here",
    )
    parser.add_argument("--dist_coordinator", default=None,
                        help="host:port of rank 0 for a multi-process run (one process "
                        "a card), or 'auto' for torchrun's variables")
    parser.add_argument("--dist_num_processes", default=None, type=int,
                        help="the run's processes (with --dist_coordinator)")
    parser.add_argument("--dist_process_id", default=None, type=int,
                        help="this process's rank (with --dist_coordinator)")
