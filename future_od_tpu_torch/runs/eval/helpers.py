"""Eval-script helpers (port of runs/eval/helpers.py)."""
import os


def add_hardcoded_eval_args(args, default_checkpoint_name):
    """The training options an eval run fixes: one epoch, the net alone from
    the checkpoint, no checkpoints written, the short splits."""
    args.epochs = 1
    args.load_only_net = True
    args.restart = False
    args.no_checkpoints = True
    args.short_train = True
    args.debug = False
    args.wandb_resume_id = None
    if args.checkpoint is None:
        args.checkpoint = os.path.join("checkpoints", default_checkpoint_name)
    assert os.path.exists(args.checkpoint) or getattr(args, "synthetic", False), (
        "Need to provide a valid checkpoint"
    )
