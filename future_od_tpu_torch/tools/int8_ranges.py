"""Activation ranges of the int8 trunk's convolutions on a trained
checkpoint, and the int8 backbone's feature error: what quant_ap_check's
int8 drop depends on. (The JAX record of its own drift_base gives ranges
up to about 1e15, 10-60x outlier channels and a 1.4 % relative feature
error; this tool has no JAX counterpart.)

Over quant_ap_check's "fit" split, in eval mode, on quant_ap_check's
float and int8 models of the checkpoint:
- for each convolution of the float trunk (the 53 that the int8 backbone
  quantizes), the max |x| of its input over the split, and its outlier
  ratio: the largest channel's max |x| over the median of the channels'
  nonzero ones;
- the relative error of the int8 backbone's output (where noise_ap_check
  adds its noise): ||int8 - float|| / ||float|| over the split.

Run on the card:  python -m future_od_tpu_torch.tools.int8_ranges [--ckpt checkpoints/drift_base]
On the CPU (the tiny model of matcher_drift_branched --check):  ... --check --ckpt DIR/drift_base
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
from typing import Dict

import torch

from future_od_tpu_torch.models.resnet import CDetrBackbone
from future_od_tpu_torch.tools import _convergence as conv
from future_od_tpu_torch.tools.quant_ap_check import make_trainer
from future_od_tpu_torch.train.step import to_device_batch


@contextlib.contextmanager
def input_ranges(model: torch.nn.Module, ranges: Dict[str, torch.Tensor]):
    """Inside, each convolution of `model`'s backbone trunks raises
    ranges[its name] to the per-channel running max |x| of its input."""
    def hook(name):
        def record(module, inputs):
            x = inputs[0].detach().float().abs()
            amax = x.amax(dim=(0, 2, 3))  # NCHW
            ranges[name] = amax if name not in ranges else torch.maximum(ranges[name], amax)
        return record

    handles = [layer.register_forward_pre_hook(hook(f"{name}.{sub}"))
               for name, m in model.named_modules() if isinstance(m, CDetrBackbone)
               for sub, layer in m.body.named_modules() if isinstance(layer, torch.nn.Conv2d)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


@contextlib.contextmanager
def backbone_outputs(model: torch.nn.Module, outputs: list):
    """Inside, each CDetrBackbone of `model` appends its output (f32) to
    `outputs`."""
    handles = [m.register_forward_hook(lambda m, i, out: outputs.append(out.detach().float()))
               for m in model.modules() if isinstance(m, CDetrBackbone)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def range_record(amax: torch.Tensor) -> dict:
    """{"amax": max |x|, "outlier_ratio": amax over the median of the
    channels' nonzero maxima (0 when every channel is 0)}."""
    nonzero = amax[amax > 0]
    top = float(amax.max())
    return {"amax": top,
            "outlier_ratio": top / float(nonzero.median()) if nonzero.numel() else 0.0}


def measure(ckpt: str, batch: int, check: bool = False, device=None) -> dict:
    """The ranges of the float trunk's convolution inputs and the int8
    backbone's relative feature error over the "fit" split."""
    float_model = make_trainer(False, ckpt, batch, check, device)._model.eval()
    int8_trainer = make_trainer(True, ckpt, batch, check, device)
    int8_model = int8_trainer._model.eval()
    ranges: Dict[str, torch.Tensor] = {}
    err2 = ref2 = 0.0
    with torch.no_grad():
        for data in int8_trainer._val_loaders["fit"]:
            data = to_device_batch(data, int8_trainer._device)
            ref, out = [], []
            with input_ranges(float_model, ranges), backbone_outputs(float_model, ref):
                float_model(data)
            with backbone_outputs(int8_model, out):
                int8_model(data)
            for r, o in zip(ref, out, strict=True):
                err2 += float((o - r).square().sum())
                ref2 += float(r.square().sum())
    convs = {name: range_record(amax) for name, amax in ranges.items()}
    stages = {}
    for name, rec in convs.items():
        stage = next((part for part in name.split(".") if part.startswith("layer")), "stem")
        s = stages.setdefault(stage, {"convs": 0, "amax": 0.0, "outlier_ratio": 0.0})
        s["convs"] += 1
        s["amax"] = max(s["amax"], rec["amax"])
        s["outlier_ratio"] = max(s["outlier_ratio"], rec["outlier_ratio"])
    return {"feature_rel_err": (err2 / ref2) ** 0.5 if ref2 else 0.0, "stages": stages,
            "convs": convs}


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ckpt", default="checkpoints/drift_base")
    parser.add_argument("--batch", type=int, default=16)
    parser.add_argument("--out", default="checkpoints/int8_ranges.json")
    conv.add_run_flags(parser)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    batch = conv.CHECK_BATCH if args.check else args.batch
    result = measure(args.ckpt, batch, args.check, conv.device_of(args))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items() if k != "convs"}, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
