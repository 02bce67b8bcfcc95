"""nuImages 13-frame clip dataset (port of future_od_tpu/data/nu_images.py).

13-frame clips with the annotated keyframe at index 6, the frames selected by
`frames` (plus an optional random offset), per-frame ego-pose IMU made
relative to the first selected frame, dense padded targets. JPEGs decode
without OpenCV (`data/image.py`), pixel for pixel as cv2.imread does.

Under `device_normalize` the video stays uint8 and the backbone normalizes
it on the device; the JAX dataset returns float32 pixels of 0-255 there
(`video.astype(np.float32)`), which its backbone does not normalize
(ROADMAP.md Queue 3).

Requires the `nuimages` devkit and the data on disk; the devkit is imported
when a dataset is built, so the rest of the package works without it.
"""
from __future__ import annotations

import os
import random
from collections import defaultdict
from typing import Callable, Optional, Sequence

import numpy as np

from future_od_tpu_torch.data.image import read_image_rgb
from future_od_tpu_torch.data.transforms import (
    JointCenterCrop,
    JointCompose,
    JointResize,
    remap_and_normalize,
)
from future_od_tpu_torch.ops.quaternion import relative_pose
from future_od_tpu_torch.ops.target_utils import construct_box_targets

ORIGINAL_IMSIZE = (900, 1600)
ANNOTATED_FRAME = 6  # 6 before (0-5), 6 after (7-12)

CATEGORY_DICT = {
    0: "Vehicle",
    1: "Truck",
    2: "Trailer",
    3: "Pedestrian",
    4: "Bus",
    5: "Motorcyclist",
    6: "Bicyclist",
    7: "ConstructionVehicle",
}
IGNORE_CATEGORY = len(CATEGORY_DICT)

# Category-token tables of the reference dataset (token hashes are dataset
# constants, not code).
DISCARD_CATEGORY_TOKENS = {
    "a86329ee68a0411fb426dcad3b21452f",  # flat.driveable_surface
    "653f7efbb9514ce7b81d44070d6208c1",  # movable_object.barrier
    "063c5e7f638343d3a7230bc3641caf97",  # movable_object.debris
    "d772e4bae20f493f98e15a76518b31d7",  # movable_object.pushable_pullable
    "85abebdccd4d46c7be428af5a6173947",  # movable_object.trafficcone
}
CATEGORY_TOKEN_MAP = {
    "63a94dfa99bb47529567cd90d3b58384": IGNORE_CATEGORY,  # animal
    "1fa93b757fc74fb197cdd60001ad8abf": 3,  # human.pedestrian.adult
    "b1c6de4c57f14a5383d9f963fbdcb5cb": 3,  # human.pedestrian.child
    "909f1237d34a49d6bdd27c2fe4581d79": 3,  # human.pedestrian.construction_worker
    "403fede16c88426885dd73366f16c34a": IGNORE_CATEGORY,  # personal_mobility
    "e3c7da112cd9475a9a10d45015424815": 3,  # police_officer
    "6a5888777ca14867a8aee3fe539b56c4": IGNORE_CATEGORY,  # stroller
    "b2d7c6c701254928a9e4d6aac9446d79": IGNORE_CATEGORY,  # wheelchair
    "0a30519ee16a4619b4f4acfe2d78fb55": IGNORE_CATEGORY,  # bicycle_rack
    "fc95c87b806f48f8a1faea2dcc2222a4": 6,  # bicycle
    "003edbfb9ca849ee8a7496e9af3025d4": 4,  # bus.bendy
    "fedb11688db84088883945752e480c2c": 4,  # bus.rigid
    "fd69059b62a3469fbaef25340c0eab7f": 0,  # car
    "5b3cd6f2bca64b83aa3d0008df87d0e4": 7,  # construction
    "7754874e6d0247f9855ae19a4028bf0e": 0,  # ego
    "732cce86872640628788ff1bb81006d4": IGNORE_CATEGORY,  # ambulance
    "7b2ff083a64e4d53809ae5d9be563504": IGNORE_CATEGORY,  # police vehicle
    "dfd26f200ade4d24b540184e16050022": 5,  # motorcycle
    "90d0f6f8e7c749149b1b6c3a029841a8": 2,  # trailer
    "6021b5187b924d64be64a702e5570edf": 1,  # truck
}


class NuImagesDataset:
    """See the module docstring."""

    def __init__(
        self,
        root_path: str,
        split: str,
        night: bool = False,
        front_camera_only: bool = False,
        max_num_objects: int = 256,
        frames: Sequence[int] = (ANNOTATED_FRAME,),
        joint_transform=None,
        max_frame_random_offset: int = 0,
        frame_offset_sampler: Optional[Callable[[], int]] = None,
        annotated_frame_idx_override: Optional[int] = None,
        device_normalize: bool = False,
    ):
        from nuimages import NuImages  # lazy: devkit optional

        assert split in ("mini", "train", "val", "test")
        self.root_path = root_path
        self.max_num_objects = max_num_objects
        self.frames = list(frames)
        self.joint_transform = joint_transform or JointCompose(
            [JointResize(size=(256, 962)), JointCenterCrop(size=(256, 960))]
        )
        self.max_frame_random_offset = max_frame_random_offset
        self.frame_offset_sampler = frame_offset_sampler
        # emit uint8 video; the backbone normalizes on the device (4x fewer
        # host-to-device bytes, models/resnet.py::device_normalize)
        self.device_normalize = device_normalize
        self.annotated_frame_idx_override = annotated_frame_idx_override

        self.nuimages = NuImages(version="v1.0-" + split, dataroot=root_path)
        self.object_anns_dict = defaultdict(list)
        self.samples = []
        self._init_data(night, front_camera_only)

    def _night_log_tokens(self):
        # The logfile name encodes the local capture hour in its fifth dash
        # field (e.g. "n008-2018-08-01-12-00-00" -> 12); night mode keeps only
        # logs whose hour falls outside the 06..18 daytime window.
        night = set()
        for log in self.nuimages.log:
            hour = int(log["logfile"].split("-")[4])
            if not 6 < hour < 18:
                night.add(log["token"])
        return night

    def _front_camera_cs_tokens(self):
        # calibrated_sensor -> sensor join reduced to a membership set, so the
        # per-sample camera check is a single `in`.
        front_sensors = {
            s["token"] for s in self.nuimages.sensor if s["channel"] == "CAM_FRONT"
        }
        return {
            cs["token"]
            for cs in self.nuimages.calibrated_sensor
            if cs["sensor_token"] in front_sensors
        }

    def _init_data(self, night: bool, front_camera_only: bool):
        """Index annotations by frame and select usable clips.

        Optional night-hours and front-camera restrictions, plus a
        full 13-frame context with the annotated keyframe dead-center; a
        skipped-sample count is printed for data-integrity visibility.
        """
        for ann in self.nuimages.object_ann:
            if ann["category_token"] not in DISCARD_CATEGORY_TOKENS:
                self.object_anns_dict[ann["sample_data_token"]].append(ann)

        night_logs = self._night_log_tokens() if night else None
        front_cs = self._front_camera_cs_tokens() if front_camera_only else None

        for sample in self.nuimages.sample:
            if night_logs is not None and sample["log_token"] not in night_logs:
                continue
            if front_cs is not None:
                key_sd = self.nuimages.get("sample_data", sample["key_camera_token"])
                if key_sd["calibrated_sensor_token"] not in front_cs:
                    continue
            sd_tokens = self.nuimages.get_sample_content(sample["token"])
            full_clip = (
                len(sd_tokens) == 13
                and sd_tokens[ANNOTATED_FRAME] == sample["key_camera_token"]
            )
            if full_clip:
                self.samples.append((sample, sd_tokens))

        num_skipped = len(self.nuimages.sample) - len(self.samples)
        if num_skipped:
            print(f"skipped {num_skipped} samples")

    def __len__(self):
        return len(self.samples)

    def _select_frames(self):
        if self.frame_offset_sampler is not None:
            off = self.frame_offset_sampler()
        else:
            off = random.randint(0, self.max_frame_random_offset)
        return [f + off for f in self.frames]

    def _read_video(self, sd_tokens, frame_ids) -> np.ndarray:
        frames = []
        for fi in frame_ids:
            sd = self.nuimages.get("sample_data", sd_tokens[fi])
            frames.append(
                read_image_rgb(os.path.join(self.root_path, sd["filename"]))
            )
        video = np.stack(frames)
        return video if self.device_normalize else remap_and_normalize(video)

    # ego_pose fields stacked into IMU columns, with their vector widths
    # (speed is a scalar per pose and becomes an (L, 1) column).
    POSE_FIELDS = (
        ("translation", 3),
        ("acceleration", 3),
        ("rotation", 4),
        ("rotation_rate", 3),
        ("speed", 1),
    )

    def _get_imu(self, sd_tokens, frame_ids):
        """Column-stacked ego_pose IMU; translation/rotation are re-expressed
        relative to the first selected frame."""
        poses = []
        for fi in frame_ids:
            sd = self.nuimages.get("sample_data", sd_tokens[fi])
            poses.append(self.nuimages.get("ego_pose", sd["ego_pose_token"]))
        cols = {
            name: np.asarray([p[name] for p in poses], np.float32).reshape(-1, dim)
            for name, dim in self.POSE_FIELDS
        }
        translation, rotation = relative_pose(cols["translation"], cols["rotation"])
        return translation, cols["acceleration"], rotation, cols["rotation_rate"], cols["speed"]

    def __getitem__(self, idx):
        sample, sd_tokens = self.samples[idx]
        frame_ids = self._select_frames()
        video = self._read_video(sd_tokens, frame_ids)
        annotated_frame_idx = (
            self.annotated_frame_idx_override
            if self.annotated_frame_idx_override is not None
            else frame_ids.index(ANNOTATED_FRAME)
        )
        imu = self._get_imu(sd_tokens, frame_ids)

        annos = self.object_anns_dict[sample["key_camera_token"]]
        boxes = (
            np.stack([np.asarray(o["bbox"], np.float32) for o in annos])
            if annos
            else np.zeros((0, 4), np.float32)
        )
        classes = np.asarray(
            [CATEGORY_TOKEN_MAP[o["category_token"]] for o in annos], np.int64
        )
        video, boxes, classes = self.joint_transform(video, boxes, classes)
        boxes, classes, ignore_boxes, active = construct_box_targets(
            boxes, classes, self.max_num_objects, ignore_categories={IGNORE_CATEGORY}
        )
        return {
            "video": video if self.device_normalize else video.astype(np.float32),
            "boxes": boxes,
            "classes": classes,
            "active": active,
            "annotated_frame_idx": np.int64(annotated_frame_idx),
            "ignore_boxes": ignore_boxes,
            "weather": "none",
            "sun_elevation": -1.0,
            "translation": imu[0].astype(np.float32),
            "acceleration": imu[1],
            "rotation": imu[2].astype(np.float32),
            "rotation_rate": imu[3],
            "speed": imu[4],
            "idf": f"{idx}",
        }
