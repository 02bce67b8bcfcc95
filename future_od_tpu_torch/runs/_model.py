"""The run scripts' model constructor (port of runs/_model.py): the flagship
every run uses, SpatioTemporalDETR(FuturePredCore(ResNet-50 + IMU MLP +
6-layer egodeep encoder, no joint encoder, recurrent 2-image decoder)), on
the card (raises without one). `store_attention=True` builds the flagship
whose decoder image attentions capture their weights
(`models/st_detr.py::captured_attention`), as the demo's attention maps
read them."""
from __future__ import annotations

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs


def build_model(args, detr_args: SpatioTemporalDETRArgs, store_attention: bool = False):
    del args  # no DDP wrapper: the data-parallel train step reduces (train/step.py)
    return build_flagship(detr_args, store_attention=store_attention)
