"""Optimizer assembly (port of future_od_tpu/train/optimizer.py).

AdamW with two groups: "main" at `lr` and "backbone" (every parameter under
`backbone`) at `lr_backbone`; the stem and layer1 of the backbone body are
"frozen" under `freeze_stem` and stay out of the optimizer. Betas (0.9,
0.999), eps 1e-8 and `weight_decay` on every trained parameter, as optax's
`adamw` applies them. The global-norm clip is `clip_by_global_norm_`, written
out to equal optax's `clip_by_global_norm`; the train step applies it before
`step()`. Over a model axis each rank keeps AdamW's moments of its own share
of a cut parameter (elementwise, so they are the one process's numbers),
and `global_norm` sums the shares' squares over the model group.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
from torch import nn

GROUPS = ("main", "backbone")


def get_lr_func(epochs: int) -> Callable[[int], float]:
    """10% linear warmup, x0.5 after 60%, x0.1 after 90%, on the 0-based
    epoch index (the LambdaLR convention)."""
    warmup, drop_1, drop_2 = int(0.1 * epochs), int(0.6 * epochs), int(0.9 * epochs)

    def f(e: int) -> float:
        if e < warmup:
            return (e + 1) / (1 + warmup)
        if e <= drop_1:
            return 1.0
        if e <= drop_2:
            return 0.5
        return 0.1

    return f


def param_label(name: str, freeze_stem: bool = True) -> str:
    """main / backbone / frozen for the parameter `name`: the backbone body
    outside layer2-4 is frozen under freeze_stem; anything under `backbone`
    (body or input_proj) trains at the backbone rate; the rest is main."""
    if "backbone" in name:
        if freeze_stem and "body" in name and not any(f"layer{i}" in name for i in (2, 3, 4)):
            return "frozen"
        return "backbone"
    return "main"


def param_labels(model: nn.Module, freeze_stem: bool = True) -> Dict[str, str]:
    """{parameter name: label} over the model's parameters."""
    return {name: param_label(name, freeze_stem) for name, _ in model.named_parameters()}


class AdamWClipped(torch.optim.AdamW):
    """torch.optim.AdamW that also carries the global-norm clip's max_norm
    (0 or None: no clip)."""

    def __init__(self, params, max_norm: float = 0.1, **kwargs):
        super().__init__(params, **kwargs)
        self.max_norm = max_norm

    def parameters(self) -> Iterable[torch.Tensor]:
        for group in self.param_groups:
            yield from group["params"]


def build_optimizer(model: nn.Module, lr: float, lr_backbone: float, weight_decay: float = 1e-4,
                    max_norm: float = 0.1, freeze_stem: bool = True) -> AdamWClipped:
    """AdamW over the model's non-frozen parameters in the groups "main"
    and "backbone" (each group's `name` key says which)."""
    labels = param_labels(model, freeze_stem)
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        if labels[name] != "frozen":
            groups[labels[name]].append(p)
    rates = {"main": lr, "backbone": lr_backbone}
    return AdamWClipped(
        [{"params": groups[g], "lr": rates[g], "name": g} for g in GROUPS if groups[g]],
        max_norm=max_norm, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
    )


def global_norm(grads: Iterable[torch.Tensor], sharded: Optional[Sequence[bool]] = None,
                axis=None) -> torch.Tensor:
    """sqrt(Σ g²) over every gradient, in f32 (optax.global_norm). Over a
    model axis (`parallel/distributed.py::ModelAxis`), `sharded[i]` says
    whether grads[i] is this rank's share of a cut parameter: the shares'
    squares are summed over the model group, and the replicated gradients,
    alike on every rank of it, count once."""
    grads = list(grads)
    if axis is None or not any(sharded):
        return torch.sqrt(sum(g.float().pow(2).sum() for g in grads))
    from future_od_tpu_torch.parallel.distributed import all_reduce_sum

    squares = [g.float().pow(2).sum() for g in grads]
    cut = all_reduce_sum(torch.stack([s for s, c in zip(squares, sharded) if c]).sum(),
                         axis.group)
    return torch.sqrt(sum((s for s, c in zip(squares, sharded) if not c), cut))


def clip_by_global_norm_(grads: Iterable[torch.Tensor], norm: torch.Tensor,
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place, given the global norm: when
    norm >= max_norm each g becomes g / norm * max_norm (no epsilon, unlike
    torch's clip_grad_norm_). Reads the norm on the host once."""
    if not float(norm) < max_norm:
        for g in grads:
            g.div_(norm).mul_(max_norm)


def set_learning_rates(optimizer: torch.optim.Optimizer, lr_main: float,
                       lr_backbone: float) -> None:
    """Set the two groups' learning rates in place (per epoch)."""
    rates = {"main": lr_main, "backbone": lr_backbone}
    for group in optimizer.param_groups:
        group["lr"] = rates[group["name"]]
