"""Shared run-script helpers (port of runs/_helper.py): the Trainer built
from loaders, model and arguments, the argument parser with the JAX scripts'
option strings, and the LR schedule.

The port runs in one process on one card. Options it cannot honour yet
raise NotImplementedError naming their ROADMAP.md item when a run uses them,
never silently: `--mesh_model` > 1 and the `--dist_*` options (item 4),
`--bf16` (item 1a), `--accum` > 1 (item 1b), `--int8` (item 6), and in the
loader functions `--device_normalize` and `--loader grain` (items 2a, 2b).
`--prng` picks the JAX package's dropout generator, which torch's has no
counterpart for; it changes nothing here.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from future_od_tpu_torch.data import nu_images, nu_scenes, synthetic
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


def refuse_unported(args) -> None:
    """Raise NotImplementedError for a run option the port does not honour
    yet (the Trainer refuses `--bf16` and `--accum` > 1 itself)."""
    if int(getattr(args, "mesh_model", 1)) > 1:
        raise NotImplementedError(
            "--mesh_model > 1 (tensor parallelism) is not ported yet "
            "(ROADMAP.md Queue 1 item 4)")
    dist = [f"--{k}" for k in ("dist_coordinator", "dist_num_processes", "dist_process_id")
            if getattr(args, k, None) is not None]
    if dist:
        raise NotImplementedError(
            f"{', '.join(dist)}: multi-process runs are not ported yet "
            "(ROADMAP.md Queue 1 item 4)")
    if getattr(args, "int8", False):
        raise NotImplementedError(
            "--int8 (the int8 PTQ backbone) is not ported yet (ROADMAP.md Queue 1 item 6)")


def get_trainer(args, config, detr_args, lr_func, model, train_loader, val_loaders,
                tracker=None):
    refuse_unported(args)
    trainer = Trainer(
        model=model,
        detr_args=detr_args,
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
        help="tensor-parallel axis size; > 1 is not ported yet (raises)",
    )
    parser.add_argument(
        "--matcher", default="auction", choices=["auction", "hungarian"],
        help="set-matching solver (auction = on the device, hungarian = exact, "
        "scipy on the host)",
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
        help="int8 PTQ backbone for inference/eval; not ported yet (raises)",
    )
    parser.add_argument(
        "--loader", default="thread", choices=["thread", "grain"],
        help="input pipeline backend: the thread pool; grain is not ported "
        "yet (raises)",
    )
    parser.add_argument(
        "--device_normalize", action="store_true", default=False,
        help="ship uint8 video and normalize on the device; not ported yet "
        "(raises)",
    )
    parser.add_argument(
        "--checkpoint_every_iters", default=0, type=int,
        help="also checkpoint mid-epoch every N train iterations (preemption safety)",
    )
    parser.add_argument(
        "--bf16", action="store_true", default=False,
        help="bfloat16 forward/backward with f32 master params; not ported "
        "yet (raises)",
    )
    parser.add_argument(
        "--accum", type=int, default=1,
        help="gradient-accumulation micro-steps; > 1 is not ported yet (raises)",
    )
    parser.add_argument(
        "--prng", default="rbg", choices=["rbg", "threefry2x32"],
        help="the JAX package's dropout-bit PRNG; torch's generator has no "
        "counterpart, so it changes nothing here",
    )
    parser.add_argument("--dist_coordinator", default=None,
                        help="multi-host coordinator; not ported yet (raises)")
    parser.add_argument("--dist_num_processes", default=None, type=int,
                        help="not ported yet (raises)")
    parser.add_argument("--dist_process_id", default=None, type=int,
                        help="not ported yet (raises)")
