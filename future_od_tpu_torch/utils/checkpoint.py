"""Checkpoint save and load (port of future_od_tpu/utils/checkpoint.py).

One `torch.save` file per name, `<dir>/<name>`, overwritten each epoch, as
the reference writes its `.pth.tar`. The Trainer stores the reference's dict
`{epoch, net_type, net, optimizer, lr_schedule, stats, device}` plus the run's
`detr_args` and train `step`, and under `<name>_final` the net alone (with
`net_type` and `detr_args`). A save writes a temporary file beside the target
and renames it over the target, so the previous checkpoint stays whole until
the new one is complete, and a save is durable when it returns.
"""
from __future__ import annotations

import os
from typing import Any, Dict, Optional

import torch


def _path(checkpoint_dir: str, name: str) -> str:
    return os.path.abspath(os.path.join(os.path.expanduser(checkpoint_dir), name))


def save_checkpoint(checkpoint_dir: str, name: str, blob: Dict[str, Any]) -> str:
    """Atomically overwrite <dir>/<name> with `blob`; returns the path."""
    path = _path(checkpoint_dir, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        torch.save(blob, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def load_checkpoint(checkpoint_dir: str, name: str,
                    map_location=None) -> Optional[Dict[str, Any]]:
    """The dict saved as <dir>/<name>, its tensors on `map_location`; None
    when there is no such file. Only tensors and plain Python values are
    unpickled (`weights_only`)."""
    path = _path(checkpoint_dir, name)
    if not os.path.isfile(path):
        return None
    return torch.load(path, map_location=map_location, weights_only=True)
