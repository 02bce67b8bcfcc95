"""The run scripts' model constructor (port of runs/_model.py): the flagship
every run uses, SpatioTemporalDETR(FuturePredCore(ResNet-50 + IMU MLP +
6-layer egodeep encoder, no joint encoder, recurrent 2-image decoder)), on
the card (raises without one)."""
from __future__ import annotations

from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs


def build_model(args, detr_args: SpatioTemporalDETRArgs, store_attention: bool = False):
    del args  # one process, one card: no DDP wrapping
    if store_attention:
        raise NotImplementedError(
            "attention-weight capture (store_attention) is not ported yet "
            "(ROADMAP.md Queue 1 item 3)")
    return build_flagship(detr_args)
