"""Model assembly (port of future_od_tpu/models/build.py): the flagship, the
joint-encoder ablations, the single-frame core and the tracker baseline.

Every builder draws its weights on the CPU from `generator` (default: seed
0) with the JAX package's initializers, moves the model to `device`
(default CUDA; raises without a card) and returns it in eval mode. The
detector's modes (slotstates, "attend all at once", when the first decoder
layer is special) are `_detector`'s knobs; `assemble` finishes a model from
any core so assembled.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from future_od_tpu_torch.models.cores import (
    CDetrDetectorSpatioTemporal,
    FuturePredCore,
    JointEncoder,
    JointEncoderF2F,
    JointEncoderSequential,
    SeparateEncoder,
    SingleFrameCore,
    TrackerBaselineCore,
)
from future_od_tpu_torch.models.layers import SelfAttention, init_linear_
from future_od_tpu_torch.models.resnet import init_conv_
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETR, SpatioTemporalDETRArgs
from future_od_tpu_torch.utils.device import DeviceLike, resolve_device


def init_weights_(model: nn.Module, generator: torch.Generator) -> None:
    """Random init with the JAX package's initializers, drawn from
    `generator`: xavier-uniform linear weights with torch-default biases,
    fan-out normal convs with zero biases, identity frozen BN, and the
    detector's heads."""
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


def _separate_encoder(args: SpatioTemporalDETRArgs, use_imu: bool = True,
                      concat_imu: bool = False) -> SeparateEncoder:
    """The per-frame encoder of every builder; `concat_imu` (no JAX builder
    sets it) adds the IMU embedding to the features instead. `int8_static`
    implies the int8 backbone (`models/resnet.py`)."""
    return SeparateEncoder(
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
        backbone_int8=args.int8_backbone or args.int8_static,
        backbone_int8_static=args.int8_static,
        use_encoder=args.enc_layers > 0,
        use_imu=use_imu,
        use_egodeep=use_imu,
        concat_imu=concat_imu,
    )


def _detector(args: SpatioTemporalDETRArgs, num_images: int,
              image_memory_mode: str = "attend one at a time",
              first_layer_special_when: str = "always", use_slotstates: bool = False,
              store_attention: bool = False,
              use_egodeep: bool = True) -> CDetrDetectorSpatioTemporal:
    """The detector of every builder. `use_egodeep`: whether the encoder
    feeds it egodeep tokens (the JAX decoder creates its egodeep attention
    only when it is given them)."""
    return CDetrDetectorSpatioTemporal(
        num_classes=args.num_classes,
        hidden_dim=args.hidden_dim,
        num_queries=args.num_queries,
        dec_layers=args.dec_layers,
        dec_heads=args.nheads,
        ff_dim=args.dim_feedforward,
        dropout=args.dropout,
        num_images=num_images,
        aux_loss=args.aux_loss,
        use_slotstates=use_slotstates,
        use_egodeep=use_egodeep,
        first_layer_special_when=first_layer_special_when,
        image_memory_mode=image_memory_mode,
        store_attention=store_attention,
    )


def assemble(core: nn.Module, args: SpatioTemporalDETRArgs, device: DeviceLike = None,
             generator: Optional[torch.Generator] = None) -> SpatioTemporalDETR:
    """SpatioTemporalDETR over `core`, initialized from `generator` (default:
    seed 0), on `device` (default CUDA; raises without a card), in eval
    mode."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = SpatioTemporalDETR(core, args)
    init_weights_(model, generator)
    return model.to(device).eval()


def build_flagship(
    args: SpatioTemporalDETRArgs,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
    store_attention: bool = False,
) -> SpatioTemporalDETR:
    """The paper's spatiotemporal + IMU model: ResNet + IMU MLP + per-frame
    egodeep encoder, no joint encoder, recurrent decoder over 2 frames with
    first_layer_special "always"; `aux_loss`, the stem+layer1 `freeze_stem`
    cut and the `space_to_depth` stem as `args` sets them. With
    `store_attention` every decoder image attention captures its weights
    (`models/st_detr.py::captured_attention`). `int8_backbone` runs the
    trunk's convolutions on the int8 path in inference, `int8_static` with
    calibrated ranges (`models/resnet.py::int8_calibration`; before that
    `ops/quant.py::assert_calibrated(model)` raises)."""
    core = FuturePredCore(
        separate_encoder=_separate_encoder(args, use_imu=True),
        detector=_detector(args, num_images=2, store_attention=store_attention),
        no_temporal_pos=True,
        encode_offset=args.encode_offset,
    )
    return assemble(core, args, device, generator)


def build_with_joint_encoder(
    args: SpatioTemporalDETRArgs,
    kind: str = "joint",
    joint_layers: int = 2,
    num_frames: int = 2,
    store_attention: bool = False,
    device: DeviceLike = None,
    generator: Optional[torch.Generator] = None,
) -> SpatioTemporalDETR:
    """The flagship with a cross-frame joint encoder (the paper's
    ablations): "joint" (attention over every past frame's tokens at once),
    "sequential" (one encoder a frame, attending to the previous output and
    the num_frames-1 earlier raw frames) or "f2f" (dilated convolutions over
    the stacked frames, one future map, so a one-image detector). Positions
    carry the temporal term."""
    if kind == "joint":
        joint = JointEncoder(joint_layers, args.hidden_dim, args.enc_nheads,
                             args.dim_feedforward, args.dropout, use_egodeep=True)
    elif kind == "sequential":
        joint = JointEncoderSequential(
            joint_layers, args.hidden_dim, args.enc_nheads, args.dim_feedforward,
            args.dropout, num_previmages=num_frames - 1, use_prevout=True, use_egodeep=True)
    elif kind == "f2f":
        joint = JointEncoderF2F(args.hidden_dim, num_frames)
    else:
        raise ValueError(f"unknown joint encoder kind: {kind}")
    core = FuturePredCore(
        separate_encoder=_separate_encoder(args, use_imu=True),
        detector=_detector(args, num_images=1 if kind == "f2f" else 2,
                           store_attention=store_attention),
        joint_encoder=joint,
        no_temporal_pos=False,
        encode_offset=args.encode_offset,
    )
    return assemble(core, args, device, generator)


def build_single_frame(args: SpatioTemporalDETRArgs, use_imu: bool = False,
                       device: DeviceLike = None,
                       generator: Optional[torch.Generator] = None) -> SpatioTemporalDETR:
    """The single-frame ablation core (runs/nuim_single_frame.py's model)."""
    core = SingleFrameCore(
        separate_encoder=_separate_encoder(args, use_imu=use_imu),
        detector=_detector(args, num_images=1, use_egodeep=use_imu),
        no_temporal_pos=True,
    )
    return assemble(core, args, device, generator)


def build_tracker_baseline(args: SpatioTemporalDETRArgs, use_imu: bool = False,
                           device: DeviceLike = None,
                           generator: Optional[torch.Generator] = None) -> SpatioTemporalDETR:
    """The tracker baseline's core; its parameters are the single-frame
    core's, so a single-frame checkpoint loads into it."""
    core = TrackerBaselineCore(
        separate_encoder=_separate_encoder(args, use_imu=use_imu),
        detector=_detector(args, num_images=1, use_egodeep=use_imu),
        no_temporal_pos=True,
    )
    return assemble(core, args, device, generator)
