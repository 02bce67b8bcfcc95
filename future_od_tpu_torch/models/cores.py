"""Model cores (port of future_od_tpu/models/cores.py): per-frame encoding,
the cross-frame encoders, the recurrent frame-memory detector, and the
paper's model families (FuturePredCore, SingleFrameCore,
TrackerBaselineCore).

Images are NHWC; features (B, L, h, w, D) channels-last. All frames run the
backbone and the per-frame encoder as one folded (B·L) batch. The detector
runs "attend one at a time" (one decoder pass per frame with an image memory
of up to num_images frames; without slotstates a non-final frame's decoder
output is never read, so that pass is skipped and the recurrence carries
only the raw frame features) or "attend all at once" (one pass over the
l·h·w tokens). Every module is built only where the JAX package creates its
parameters, so the port's state_dict names exactly the JAX tree's leaves.
"""
from __future__ import annotations

import math
import os
from typing import List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from future_od_tpu_torch.models.decoder import TransformerDecoder
from future_od_tpu_torch.models.encoder import TransformerEncoder
from future_od_tpu_torch.models.layers import MLP, row_parallel
from future_od_tpu_torch.models.precision import cast_like
from future_od_tpu_torch.models.resnet import CDetrBackbone
from future_od_tpu_torch.ops.misc import inverse_sigmoid
from future_od_tpu_torch.ops.posenc import spatial_encoding, spatio_temporal_encoding
from future_od_tpu_torch.parallel.distributed import ModelAxis, copy_to_model


class ImuEncoder(nn.Sequential):
    """IMU embedding MLP: Linear(imu_dim -> width) -> ReLU -> Linear(-> dim)
    (keys `0` and `2`; the JAX `fc1`, column-parallel, and `fc2`,
    row-parallel, over a model axis: models/layers.py)."""

    def __init__(self, imu_dim: int, dim: int, width: int = 128):
        super().__init__(nn.Linear(imu_dim, width), nn.ReLU(), nn.Linear(width, dim))
        self.model_axis: Optional[ModelAxis] = None

    def splits_over(self, size: int) -> bool:
        return self[0].out_features % size == 0

    def forward(self, x):
        axis = self.model_axis
        return row_parallel(F.relu(self[0](copy_to_model(x, axis))), self[2], axis)


class SeparateEncoder(nn.Module):
    """Per-frame feature extraction: backbone on the folded (B·L) frames,
    IMU -> egodeep token (under `use_imu`), per-frame transformer encoder
    over the h·w tokens (under `use_encoder`) with egodeep cross-attention
    (under `use_egodeep`). `concat_imu` adds the IMU embedding to every
    feature instead, and then no egodeep token leaves the encoder."""

    def __init__(self, hidden_dim: int, imu_dim: int, enc_layers: int = 6,
                 enc_heads: int = 8, ff_dim: int = 2048, dropout: float = 0.1,
                 backbone_name: str = "resnet50", backbone_dilation: bool = False,
                 freeze_stem: bool = False, backbone_space_to_depth: bool = False,
                 backbone_int8: bool = False, backbone_int8_static: bool = False,
                 use_encoder: bool = True, use_imu: bool = True, use_egodeep: bool = True,
                 concat_imu: bool = False):
        super().__init__()
        self.concat_imu, self.use_egodeep = concat_imu, use_egodeep
        self.backbone = CDetrBackbone(hidden_dim, backbone_name, backbone_dilation, freeze_stem,
                                      backbone_space_to_depth, backbone_int8,
                                      backbone_int8_static)
        self.imu_layers = ImuEncoder(imu_dim, hidden_dim) if use_imu else None
        self.transformer = None
        if use_encoder and enc_layers > 0:
            self.transformer = TransformerEncoder(
                enc_layers, hidden_dim, enc_heads, ff_dim, dropout,
                use_egodeep=use_egodeep and self.gives_egodeep)

    @property
    def gives_egodeep(self) -> bool:
        """Whether forward returns egodeep tokens (given IMU data)."""
        return self.imu_layers is not None and not self.concat_imu

    def forward(self, images, imu=None):
        """images (B, L, H, W, C), C = 3 (or 12, host-packed, with the
        space-to-depth stem); imu (B, L, imu_dim). Returns features
        (B, L, h, w, D) and egodeep (B, L, D) or None."""
        B, L, H, W, C = images.shape
        features = self.backbone(images.reshape(B * L, H, W, C))
        _, h, w, D = features.shape
        egodeep = None
        if imu is not None and self.imu_layers is not None:
            egodeep = self.imu_layers(cast_like(imu, features))
        if self.concat_imu and egodeep is not None:
            features = features + egodeep.reshape(B * L, 1, 1, D)
            egodeep = None
        if self.transformer is not None:
            pos = spatial_encoding(h, w, D, device=features.device)
            pos = cast_like(pos.reshape(1, h * w, D), features)
            tokens = features.reshape(B * L, h * w, D)
            ego_tok = (egodeep.reshape(B * L, 1, D)
                       if egodeep is not None and self.use_egodeep else None)
            features = self.transformer(tokens, pos, ego_tok)
        return features.reshape(B, L, h, w, D), egodeep


def _broadcast_pos(pos_enc, features):
    """pos_enc (L, h, w, D) or (B, L, h, w, D) -> (B, L, h, w, D) in the
    features' dtype."""
    pos_enc = cast_like(pos_enc, features)
    return pos_enc.expand(features.shape) if pos_enc.ndim == 5 else (
        pos_enc[None].expand(features.shape))


class JointEncoder(nn.Module):
    """Joint attention over all l·h·w tokens at once; egodeep (B, L, D)
    enters as L tokens."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1, use_egodeep: bool = False):
        super().__init__()
        self.transformer = TransformerEncoder(num_layers, dim, num_heads, ff_dim, dropout,
                                              use_egodeep=use_egodeep)

    def forward(self, features, pos_enc, egodeep=None):
        B, L, h, w, D = features.shape
        tokens = features.reshape(B, L * h * w, D)
        pos = _broadcast_pos(pos_enc, features).reshape(B, L * h * w, D)
        tokens = self.transformer(tokens, pos, egodeep)
        return tokens.reshape(B, L, h, w, D), pos_enc


class JointEncoderSequential(nn.Module):
    """Causal per-frame encoder with a growing frame memory: one
    TransformerEncoder (one set of weights) applied once a frame, attending
    to the previous frame's output (prevout) and to the raw earlier frames,
    newest first."""

    def __init__(self, num_layers: int, dim: int, num_heads: int, ff_dim: int = 2048,
                 dropout: float = 0.1, num_previmages: int = 0, use_prevout: bool = True,
                 use_egodeep: bool = False):
        super().__init__()
        self.transformer = TransformerEncoder(
            num_layers, dim, num_heads, ff_dim, dropout, num_previmages=num_previmages,
            use_prevout=use_prevout, use_egodeep=use_egodeep)

    def forward(self, features, pos_enc, egodeep=None):
        B, L, h, w, D = features.shape
        pos = _broadcast_pos(pos_enc, features).reshape(B, L, h * w, D)
        out = None
        memory: List[torch.Tensor] = []
        outputs = []
        for l in range(L):
            frame = features[:, l].reshape(B, h * w, D)
            ego = egodeep[:, l : l + 1] if egodeep is not None else None
            out = self.transformer(frame, pos[:, l], ego, prevout=out,
                                   image_feature_memory=memory)
            memory = [frame] + memory
            outputs.append(out.reshape(B, h, w, D))
        return torch.stack(outputs, dim=1), pos_enc


# (width in multiples of hidden_dim, kernel, dilation) of F2F's convolutions
F2F_SPEC = ((2, 1, 1), (2, 3, 2), (2, 3, 2), (1, 3, 4), (1, 3, 8), (1, 3, 2), (1, 7, 1))


class JointEncoderF2F(nn.Module):
    """F2F-style dilated conv stack over the frames stacked into channels
    (channel l·D + d), "SAME" padded, relu after every conv but the last;
    returns one future feature map (B, 1, h, w, D) and the last frame's
    positions."""

    def __init__(self, hidden_dim: int, num_frames: int):
        super().__init__()
        self.hidden_dim = hidden_dim
        widths = [num_frames * hidden_dim] + [m * hidden_dim for m, _, _ in F2F_SPEC]
        self.convs = nn.ModuleList(
            nn.Conv2d(widths[i], widths[i + 1], k, dilation=d, padding=d * (k - 1) // 2)
            for i, (_, k, d) in enumerate(F2F_SPEC)
        )

    def forward(self, features, pos_enc, egodeep=None):
        del egodeep
        B, L, h, w, D = features.shape
        x = features.permute(0, 1, 4, 2, 3).reshape(B, L * D, h, w)
        for i, conv in enumerate(self.convs):
            x = conv(x)
            if i < len(self.convs) - 1:
                x = F.relu(x)
        out = x.permute(0, 2, 3, 1).reshape(B, 1, h, w, self.hidden_dim)
        out_pos = pos_enc[-1:] if pos_enc.ndim == 4 else pos_enc[:, -1:]
        return out, out_pos


class CDetrDetectorSpatioTemporal(nn.Module):
    """Recurrent conditional-DETR detection head: learned query embeddings;
    in "attend one at a time" mode one decoder pass per frame over the
    current frame plus up to num_images-1 remembered ones (with
    `use_slotstates`, the previous pass's final level as a state the
    queries attend to), in "attend all at once" mode one pass over every
    frame's tokens. The first decoder layer is special on every pass
    ("always"), on the first frame's ("first frame") or never. Only the
    final frame's prediction is returned: its final decoder level, and in
    training with `aux_loss` also the earlier levels (`aux_outputs`); in
    eval too when the caller asks (`aux_levels`, the eval step's loss).
    FUTURE_OD_NO_DEC_SKIP=1 runs the dead passes too (an A/B gate; the
    output is the same)."""

    def __init__(self, num_classes: int, hidden_dim: int, num_queries: int = 300,
                 dec_layers: int = 6, dec_heads: int = 8, ff_dim: int = 2048,
                 dropout: float = 0.1, num_images: int = 1, aux_loss: bool = False,
                 use_slotstates: bool = False, use_egodeep: bool = True,
                 first_layer_special_when: str = "always",
                 image_memory_mode: str = "attend one at a time",
                 store_attention: bool = False):
        super().__init__()
        if first_layer_special_when not in ("first frame", "always", "never"):
            raise ValueError(f"first_layer_special_when {first_layer_special_when!r}")
        if image_memory_mode not in ("attend one at a time", "attend all at once"):
            raise ValueError(f"image_memory_mode {image_memory_mode!r}")
        self.num_queries, self.hidden_dim, self.num_images = num_queries, hidden_dim, num_images
        self.aux_loss, self.use_slotstates = aux_loss, use_slotstates
        self.first_layer_special_when = first_layer_special_when
        self.all_at_once = image_memory_mode == "attend all at once"
        # layer 0's image attentions that a pass with a special first layer
        # reaches (only they project query_pos in the JAX tree): all of them
        # "always"; "first frame", the current frame's alone, and only where
        # the first frame's pass runs (with slotstates, or all at once). At
        # one frame, or under FUTURE_OD_NO_DEC_SKIP=1, the JAX tree holds
        # that projection without slotstates too; the port assumes clips of
        # two frames or more and the default gate.
        attends = 1 if self.all_at_once else num_images
        query_pos_attends = {"always": attends, "never": 0}.get(
            first_layer_special_when, 1 if use_slotstates or self.all_at_once else 0)
        self.decoder = TransformerDecoder(
            dec_layers, hidden_dim, dec_heads, ff_dim, dropout,
            # all at once, the memory is one token list: one image attention
            num_images=attends,
            use_slotstates=use_slotstates, use_egodeep=use_egodeep,
            store_attention=store_attention,
            scales_first_layer=first_layer_special_when != "always",
            query_pos_attends=query_pos_attends,
        )
        self.class_embed = nn.Linear(hidden_dim, num_classes)
        self.bbox_embed = MLP(hidden_dim, hidden_dim, 4, 3)
        self.query_embed = nn.Embedding(num_queries, hidden_dim)

    def reset_heads_(self, generator) -> None:
        """Focal-prior class bias, zero bbox delta head, N(0, 1) queries."""
        prior_prob = 0.01
        with torch.no_grad():
            self.class_embed.bias.fill_(-math.log((1 - prior_prob) / prior_prob))
            self.bbox_embed.layers[-1].weight.zero_()
            self.bbox_embed.layers[-1].bias.zero_()
            self.query_embed.weight.normal_(0.0, 1.0, generator=generator)

    def forward(self, features, pos_enc, egodeep=None, aux_levels: bool = False):
        """features (B, L, h, w, D); pos_enc (L, h, w, D) or (B, L, h, w, D);
        egodeep (B, L, D) or None; aux_levels: return the aux levels in eval
        mode too."""
        B, L, h, w, D = features.shape
        pos = _broadcast_pos(pos_enc, features)
        if self.all_at_once:
            hs, reference = self.detect(features.reshape(B, L * h * w, D),
                                        pos.reshape(B, L * h * w, D), egodeep, True, [], None)
            return self.heads(hs, reference, aux_levels)
        frames = features.reshape(B, L, h * w, D)
        skip_dead = (not self.use_slotstates
                     and os.environ.get("FUTURE_OD_NO_DEC_SKIP", "0") != "1")
        memory: List[torch.Tensor] = []
        slotstates = None
        for l in range(L):
            frame = frames[:, l]
            if not (skip_dead and l < L - 1):
                ego = egodeep[:, l : l + 1] if egodeep is not None else None
                hs, reference = self.detect(frame, pos[:, l].reshape(B, h * w, D), ego, l == 0,
                                            memory, slotstates)
                # the state is the final level, through the shared final norm
                slotstates = hs[-1] if self.use_slotstates else None
            memory = ([frame] + memory)[: self.num_images - 1]
        return self.heads(hs, reference, aux_levels)

    def detect(self, frame_features, pos_embed, egodeep, first_frame: bool,
               memory: List[torch.Tensor], slotstates: Optional[torch.Tensor]):
        """One decoder pass over the current frame + remembered frames:
        (levels (num_layers, B, M, D), reference points (B, M, 2))."""
        B = frame_features.shape[0]
        query_pos = self.query_embed.weight[None].expand(B, self.num_queries, self.hidden_dim)
        query_content = torch.zeros_like(query_pos)
        image_content_lst = [frame_features] + memory
        image_pos_lst = [pos_embed for _ in image_content_lst]
        when = self.first_layer_special_when
        return self.decoder(
            query_content, query_pos, image_content_lst, image_pos_lst,
            first_layer_special=(first_frame and when == "first frame") or when == "always",
            egodeep=egodeep, slotstates_content=slotstates,
        )  # hs (num_layers, B, M, D); reference (B, M, 2)

    def heads(self, hs, reference, aux_levels: bool = False):
        """The prediction dict of a pass's levels: the final level alone in
        inference; the aux levels in one batched call in training and in
        the eval step. FUTURE_OD_STACKED_HEADS=1 applies the heads once to
        every level (an A/B gate; the output is the same)."""
        ref_logit = inverse_sigmoid(reference)

        def apply(levels):  # (..., B, M, D) -> logits, sigmoid boxes
            deltas = self.bbox_embed(levels)
            coords = torch.cat([deltas[..., :2] + ref_logit, deltas[..., 2:]], dim=-1)
            return self.class_embed(levels), torch.sigmoid(coords)

        aux = self.aux_loss and (self.training or aux_levels)
        if os.environ.get("FUTURE_OD_STACKED_HEADS", "0") == "1":
            all_class, all_coord = apply(hs)
            final_class, final_coord = all_class[-1], all_coord[-1]
            aux_class, aux_coord = all_class[:-1], all_coord[:-1]
        else:
            final_class, final_coord = apply(hs[-1])
            if aux:
                aux_class, aux_coord = apply(hs[:-1])
        out = {"pred_logits": final_class, "pred_boxes": final_coord}
        if aux:
            out["aux_outputs"] = [
                {"pred_logits": aux_class[i], "pred_boxes": aux_coord[i]}
                for i in range(hs.shape[0] - 1)
            ]
        return out


def _drop_future(images, imu, temporal_offsets):
    """The clip without its last ("future") frame."""
    return (images[:, :-1], None if imu is None else imu[:, :-1],
            None if temporal_offsets is None else temporal_offsets[:, :-1])


def _positions(features, temporal_offsets, no_temporal_pos: bool,
               extra_temporal_offset: float = 0.0):
    B, L, h, w, D = features.shape
    return spatio_temporal_encoding(L, h, w, D, temporal_offsets=temporal_offsets,
                                    no_temporal=no_temporal_pos,
                                    extra_temporal_offset=extra_temporal_offset,
                                    device=features.device)


class FuturePredCore(nn.Module):
    """The paper's main model: drop the future frame, encode the past
    (optionally through a cross-frame `joint_encoder`), predict the future
    frame's boxes. Positions are spatial, plus the temporal term unless
    `no_temporal_pos` (from the batch's temporal offsets when the model
    passes them, `encode_offset`, else from frame indices)."""

    def __init__(self, separate_encoder: SeparateEncoder,
                 detector: CDetrDetectorSpatioTemporal,
                 joint_encoder: Optional[nn.Module] = None, no_temporal_pos: bool = True,
                 encode_offset: bool = False, extra_temporal_offset: float = 0.0):
        super().__init__()
        self.separate_encoder = separate_encoder
        self.joint_encoder = joint_encoder
        self.detector = detector
        self.no_temporal_pos, self.encode_offset = no_temporal_pos, encode_offset
        self.extra_temporal_offset = extra_temporal_offset

    def forward(self, images, imu=None, temporal_offsets=None, aux_levels: bool = False):
        images, imu, temporal_offsets = _drop_future(images, imu, temporal_offsets)
        features, egodeep = self.separate_encoder(images, imu)
        pos_enc = _positions(features, temporal_offsets, self.no_temporal_pos,
                             self.extra_temporal_offset)
        if self.joint_encoder is not None:
            features, pos_enc = self.joint_encoder(features, pos_enc, egodeep)
        return self.detector(features, pos_enc, egodeep, aux_levels)


class SingleFrameCore(nn.Module):
    """Ablation core: no frame dropped, no joint encoder; the detector sees
    all L frames."""

    def __init__(self, separate_encoder: SeparateEncoder,
                 detector: CDetrDetectorSpatioTemporal, no_temporal_pos: bool = True,
                 extra_temporal_offset: float = 0.0):
        super().__init__()
        self.separate_encoder = separate_encoder
        self.detector = detector
        self.no_temporal_pos = no_temporal_pos
        self.extra_temporal_offset = extra_temporal_offset

    def forward(self, images, imu=None, temporal_offsets=None, aux_levels: bool = False):
        features, egodeep = self.separate_encoder(images, imu)
        pos_enc = _positions(features, temporal_offsets, self.no_temporal_pos,
                             self.extra_temporal_offset)
        return self.detector(features, pos_enc, egodeep, aux_levels)


class TrackerBaselineCore(nn.Module):
    """Tracker baseline core: at L=1 plain detection (training); at L>1 the
    future frame is dropped (the host-side tracker predicts it, so its
    features are never read) and each past frame is detected alone:
    {"per_frame_preds": [one prediction dict a past frame]}, which
    `models/tracker.py::TrackerFuturePredictor` extrapolates."""

    def __init__(self, separate_encoder: SeparateEncoder,
                 detector: CDetrDetectorSpatioTemporal, no_temporal_pos: bool = True):
        super().__init__()
        self.separate_encoder = separate_encoder
        self.detector = detector
        self.no_temporal_pos = no_temporal_pos

    def forward(self, images, imu=None, temporal_offsets=None, aux_levels: bool = False):
        if images.shape[1] > 1:
            images, imu, temporal_offsets = _drop_future(images, imu, temporal_offsets)
        features, egodeep = self.separate_encoder(images, imu)
        pos_enc = _positions(features, temporal_offsets, self.no_temporal_pos)
        L = features.shape[1]
        if L == 1:
            return self.detector(features, pos_enc, egodeep, aux_levels)
        preds = []
        for l in range(L):
            ego = egodeep[:, l : l + 1] if egodeep is not None else None
            pos_l = pos_enc[l : l + 1] if pos_enc.ndim == 4 else pos_enc[:, l : l + 1]
            preds.append(self.detector(features[:, l : l + 1], pos_l, ego, aux_levels))
        return {"per_frame_preds": preds}
