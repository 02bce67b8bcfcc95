"""Model assembly (port of future_od_tpu/models/build.py::build_flagship)."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from future_od_tpu_torch.models.cores import (
    CDetrDetectorSpatioTemporal,
    FuturePredCore,
    SeparateEncoder,
)
from future_od_tpu_torch.models.layers import SelfAttention, init_linear_
from future_od_tpu_torch.models.resnet import init_conv_
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETR, SpatioTemporalDETRArgs
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with the JAX package's initializers, drawn from
    `generator`: xavier-uniform linear weights with torch-default biases,
    fan-out normal convs, identity frozen BN, and the detector's heads."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            init_linear_(module.weight, module.bias, generator)
        elif isinstance(module, nn.Conv2d):
            init_conv_(module, generator)
        elif isinstance(module, SelfAttention):
            module.reset_parameters(generator)
        elif isinstance(module, nn.LayerNorm):
            module.reset_parameters()
    for module in model.modules():
        if isinstance(module, CDetrDetectorSpatioTemporal):
            module.reset_heads_(generator)


def build_flagship(
    args: SpatioTemporalDETRArgs,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> SpatioTemporalDETR:
    """The paper's spatiotemporal + IMU model: ResNet + IMU MLP + per-frame
    egodeep encoder, no joint encoder, recurrent decoder over 2 frames with
    first_layer_special "always"; `aux_loss` and the stem+layer1
    `freeze_stem` cut and the `space_to_depth` stem as `args` sets them.
    Weights are drawn on the CPU from `generator` (default: seed 0), then
    moved to `device` (default CUDA; raises without a card). Returned in eval
    mode. The int8 backbone (`int8_backbone`, `int8_static`) is not ported
    yet and raises NotImplementedError."""
    if args.int8_backbone or args.int8_static:
        raise NotImplementedError(
            "the int8 PTQ backbone (int8_backbone / int8_static) is not ported yet "
            "(ROADMAP.md Queue 1 item 16, ops/quant.py)"
        )
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    core = FuturePredCore(
        separate_encoder=SeparateEncoder(
            hidden_dim=args.hidden_dim,
            imu_dim=args.imu_dim(),
            enc_layers=args.enc_layers,
            enc_heads=args.enc_nheads,
            ff_dim=args.dim_feedforward,
            dropout=args.dropout,
            backbone_name=args.backbone,
            backbone_dilation=args.dilation,
            freeze_stem=args.freeze_stem,
            backbone_space_to_depth=args.space_to_depth,
        ),
        detector=CDetrDetectorSpatioTemporal(
            num_classes=args.num_classes,
            hidden_dim=args.hidden_dim,
            num_queries=args.num_queries,
            dec_layers=args.dec_layers,
            dec_heads=args.nheads,
            ff_dim=args.dim_feedforward,
            dropout=args.dropout,
            num_images=2,
            aux_loss=args.aux_loss,
        ),
    )
    model = SpatioTemporalDETR(core, args)
    init_weights_(model, generator)
    return model.to(device).eval()
