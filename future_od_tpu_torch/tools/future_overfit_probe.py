"""Future-prediction overfit probe (port of tools/future_overfit_probe.py):
the flagship spatiotemporal + IMU model on 8 synthetic 3-frame clips whose
boxes show only on the 2 past frames, so the model must extrapolate the
motion to the unseen annotated frame; 3000 steps.

The JAX probe reached AP50 = 1.0 on both classes by about step 1000 (loss
23.9 -> 0.5 over 3000 steps). Prints the loss, its parts and the per-class
AP50 every 500 steps, then the median step time.

Run on the card:  python -m future_od_tpu_torch.tools.future_overfit_probe
On the CPU (tiny model, 64x96, 2 clips, 2 steps):  ... --check
"""
from __future__ import annotations

import argparse
import sys

import torch

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.tools import _convergence as conv

STEPS, INTERVAL = 3000, 500
SAMPLES, SEED, FRAMES, MAX_OBJECTS = 8, 5, 3, 3


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    conv.add_run_flags(parser)
    return parser


def run(check: bool = False, steps=None, device=None, interval=None) -> dict:
    """The probe (`--check`: its tiny twin); returns `run_probe`'s record."""
    args = conv.detr_args(check)
    model = build_flagship(args, device=device, generator=torch.Generator().manual_seed(0))
    ds = conv.dataset(check, conv.CHECK_BATCH if check else SAMPLES, SEED, num_frames=FRAMES,
                      max_objects=MAX_OBJECTS)
    steps = (conv.CHECK_STEPS if check else STEPS) if steps is None else steps
    interval = (1 if check else INTERVAL) if interval is None else interval
    return conv.run_probe(model, args, ds, steps, interval, device)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    run(args.check, device=conv.device_of(args))
    print("DONE", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
