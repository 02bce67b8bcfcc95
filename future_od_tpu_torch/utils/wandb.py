"""Weights & Biases configuration and its gated import (port of
future_od_tpu/utils/wandb.py). Without the wandb package, logging is off and
the Trainer says so once."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class WandBConfig:
    enabled: bool = False
    entity: Optional[str] = None
    project: str = "future-od-tpu"
    name: Optional[str] = None
    hyperparams: Optional[dict] = None
    watch_model: bool = False
    notes: Optional[str] = None
    num_images: int = 0
    resume_id: Optional[str] = None


def maybe_import_wandb():
    try:
        import wandb  # type: ignore

        return wandb
    except ImportError:
        return None
