"""The falsification arm of the int8 fit-AP drop (port of
tools/noise_ap_check.py).

Evaluates the float drift_base checkpoint with iid gaussian noise added to
the backbone's output at a relative magnitude matching the int8 features'
error (--rel, default 0.014): if the fit AP collapses as the int8 arm's
does, the overfit testbed is brittle to any small feature perturbation and
the int8 drop says nothing about real workloads; if it holds, the int8
error is structured and damaging.

The noise is rel * rms(features) * N(0, 1), drawn from a torch.Generator on
the features' device seeded by `noise_seed` (the JAX tool's data-dependent
seed, int32(sum(features) * 1e3)); torch's normal draws are not JAX's, so
the noise itself differs from the JAX tool's.

Run on the card:  python -m future_od_tpu_torch.tools.noise_ap_check [--rel 0.014]
On the CPU (the tiny model of matcher_drift_branched --check):  ... --check --ckpt DIR/drift_base
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys

import torch

from future_od_tpu_torch.models.resnet import CDetrBackbone
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.tools.quant_ap_check import make_trainer, split_aps

INT32_MIN, INT32_MAX = -2 ** 31, 2 ** 31 - 1


def noise_seed(features: torch.Tensor) -> int:
    """int32(sum(f32 features) * 1e3) as XLA converts: the product in f32,
    truncated toward zero, saturated at the int32 range, NaN to 0. (The
    sum's rounding follows torch's order of summation, not XLA's.)"""
    value = float(features.float().sum() * 1e3)
    if math.isnan(value):
        return 0
    if math.isinf(value):
        return INT32_MAX if value > 0 else INT32_MIN
    return max(INT32_MIN, min(INT32_MAX, math.trunc(value)))


def add_noise(features: torch.Tensor, rel: float) -> torch.Tensor:
    """features + rel * rms(features) * N(0, 1), in f32, back in the
    features' dtype."""
    f32 = features.float()
    rms = torch.sqrt(torch.mean(f32 ** 2))
    gen = torch.Generator(device=features.device).manual_seed(noise_seed(f32))
    noise = torch.randn(features.shape, generator=gen, device=features.device,
                        dtype=torch.float32)
    return (f32 + rel * rms * noise).to(features.dtype)


@contextlib.contextmanager
def backbone_noise(model: torch.nn.Module, rel: float):
    """Inside, every CDetrBackbone of `model` returns `add_noise` of its
    output (the JAX tool's method interceptor)."""
    shapes = set()

    def hook(module, inputs, output):
        out = add_noise(output, rel)
        if tuple(out.shape) not in shapes:  # the JAX tool prints once a trace
            shapes.add(tuple(out.shape))
            print(f"[noise_ap] injecting rel={rel} noise at backbone out {tuple(out.shape)}",
                  flush=True)
        return out

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, CDetrBackbone)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="checkpoints/drift_base")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--rel", type=float, default=0.014)
    parser.add_argument("--out", default="checkpoints/noise_ap.json")
    conv.add_run_flags(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    batch = conv.CHECK_BATCH if args.check else args.batch
    trainer = make_trainer(False, args.ckpt, batch, args.check, conv.device_of(args),
                           visualization_path="visualization/noise_ap")
    with backbone_noise(trainer._model, args.rel):
        trainer._run_eval()
    result = {"rel": args.rel, **split_aps(trainer)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
