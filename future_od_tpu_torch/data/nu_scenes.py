"""nuScenes sweep-clip dataset with CAN-bus IMU (port of
future_od_tpu/data/nu_scenes.py).

Samples are camera keyframes plus the surrounding sweeps matched to
`frame_offsets` (seconds, or "prev"/"next") by walking the prev/next links
with 0.01 s-rounded timestamp differences; each frame's CAN-bus pose is
matched by the nearest utime and merged with its ego_pose; 2D boxes come
from the pre-exported `image_annotations.json`; the IMU is made relative to
the first frame. JPEGs decode without OpenCV (`data/image.py`).

Under `device_normalize` the video stays uint8 and the backbone normalizes
it on the device; the JAX dataset returns float32 pixels of 0-255 there,
which its backbone does not normalize (ROADMAP.md Queue 3).

Requires the `nuscenes` devkit and the data on disk; the devkit is imported
when a dataset is built.
"""
from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import List, Optional, Sequence, Union

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
FRONT_CAMERA = "CAM_FRONT"
ALL_CAMERAS = (
    "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT",
    "CAM_FRONT", "CAM_FRONT_LEFT", "CAM_FRONT_RIGHT",
)
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
DISCARD_CATEGORIES = {
    "flat.driveable_surface",
    "movable_object.barrier",
    "movable_object.debris",
    "movable_object.pushable_pullable",
    "movable_object.trafficcone",
}
# The 8-class taxonomy.
CATEGORY_MAP = {
    "animal": IGNORE_CATEGORY,
    "human.pedestrian.adult": 3,
    "human.pedestrian.child": 3,
    "human.pedestrian.construction_worker": 3,
    "human.pedestrian.personal_mobility": IGNORE_CATEGORY,
    "human.pedestrian.police_officer": 3,
    "human.pedestrian.stroller": IGNORE_CATEGORY,
    "human.pedestrian.wheelchair": IGNORE_CATEGORY,
    "static_object.bicycle_rack": IGNORE_CATEGORY,
    "vehicle.bicycle": 6,
    "vehicle.bus.bendy": 4,
    "vehicle.bus.rigid": 4,
    "vehicle.car": 0,
    "vehicle.construction": 7,
    "vehicle.ego": 0,
    "vehicle.emergency.ambulance": IGNORE_CATEGORY,
    "vehicle.emergency.police": IGNORE_CATEGORY,
    "vehicle.motorcycle": 5,
    "vehicle.trailer": 2,
    "vehicle.truck": 1,
}
SPLIT_TO_VERSION = {
    "train": "v1.0-trainval",
    "val": "v1.0-trainval",
    "mini_train": "v1.0-mini",
    "mini_val": "v1.0-mini",
    "test": "v1.0-test",
}

Offset = Union[float, str]  # seconds, or "prev"/"next"


class NuScenesDataset:
    """See the module docstring."""

    def __init__(
        self,
        root_path: str,
        split: str,
        night: bool = False,
        front_camera_only: bool = False,
        max_num_objects: int = 256,
        frame_offsets: Sequence[Offset] = (0,),
        joint_transform=None,
        annotated_frame_idx_override: Optional[int] = None,
        filter_offsets: Optional[List[float]] = None,
        device_normalize: bool = False,
    ):
        from nuscenes import NuScenes  # lazy: devkit optional
        from nuscenes.can_bus.can_bus_api import NuScenesCanBus
        from nuscenes.utils.splits import create_splits_scenes

        split = split.replace("-", "_")
        assert split in SPLIT_TO_VERSION, f"split must be one of {SPLIT_TO_VERSION}"
        self.root_path = root_path
        self.max_num_objects = max_num_objects
        self.frame_offsets = list(frame_offsets)
        self.joint_transform = joint_transform or JointCompose(
            [JointResize(size=(256, 962)), JointCenterCrop(size=(256, 960))]
        )
        self.annotated_frame_idx_override = annotated_frame_idx_override
        # device_normalize: emit uint8 video (4x fewer host->device bytes;
        # the backbone normalizes on device — resnet.device_normalize).
        # Joint transforms then run on uint8.
        self.device_normalize = device_normalize

        self.nuscenes = NuScenes(version=SPLIT_TO_VERSION[split], dataroot=root_path)
        self.nusc_can = NuScenesCanBus(dataroot=root_path)
        self.object_anns_dict = defaultdict(list)
        self.samples: List[dict] = []
        self.imus = {}
        self._chain_pos = {}  # sample_data token -> ((timestamps, records), index)
        self._init_data(
            split, night, front_camera_only, filter_offsets, create_splits_scenes
        )

    def _init_data(self, split, night, front_camera_only, filter_offsets, split_fn):
        numeric = tuple(o for o in self.frame_offsets if not isinstance(o, str))
        assert numeric == tuple(sorted(numeric)), "Offsets must be ordered"

        print(f"Filtering out frames belonging to the {split} split")
        split_scenes = split_fn()[split]
        # Scenes without CAN-bus data are blacklisted.
        split_scenes = {
            s for s in split_scenes if int(s[-4:]) not in self.nusc_can.can_blacklist
        }
        split_samples = [
            s
            for s in self.nuscenes.sample
            if self.nuscenes.get("scene", s["scene_token"])["name"] in split_scenes
        ]

        with open(
            os.path.join(
                self.nuscenes.dataroot, self.nuscenes.version, "image_annotations.json"
            )
        ) as file:
            for o in json.load(file):
                if o["category_name"] not in DISCARD_CATEGORIES:
                    self.object_anns_dict[o["sample_data_token"]].append(o)

        skip_counter = 0
        cameras = [FRONT_CAMERA] if front_camera_only else ALL_CAMERAS
        for sample in split_samples:
            skip_counter += len(cameras)
            if night:
                scene = self.nuscenes.get("scene", sample["scene_token"])
                hour = int(
                    self.nuscenes.get("log", scene["log_token"])["logfile"].split("-")[4]
                )
                if 6 < hour < 18:
                    continue
            for camera in cameras:
                sd = self.nuscenes.get("sample_data", sample["data"][camera])
                if filter_offsets is not None:
                    if len(self._surrounding(sd, filter_offsets)) != len(filter_offsets):
                        continue
                sds = self._surrounding(sd, self.frame_offsets)
                if len(sds) < len(self.frame_offsets):
                    continue
                self.samples.append(sds)
                skip_counter -= 1

        self._init_imu()
        if skip_counter:
            print(f"skipped {skip_counter} samples")

    def _timeline(self, sample_data):
        """The full sweep chain containing `sample_data`, as (timestamps int64
        array, record list, index of sample_data). Each chain is traversed
        once (head via prev-links, then forward) and cached for every token
        on it, so repeated offset queries are array lookups."""
        hit = self._chain_pos.get(sample_data["token"])
        if hit is None:
            head = sample_data
            while head["prev"]:
                head = self.nuscenes.get("sample_data", head["prev"])
            chain = [head]
            while chain[-1]["next"]:
                chain.append(self.nuscenes.get("sample_data", chain[-1]["next"]))
            entry = (np.array([r["timestamp"] for r in chain], np.int64), chain)
            for i, rec in enumerate(chain):
                self._chain_pos[rec["token"]] = (entry, i)
            hit = self._chain_pos[sample_data["token"]]
        (times, chain), k = hit
        return times, chain, k

    def _surrounding(self, sample_data, offsets):
        """Select the sweeps matching `offsets` around a keyframe.

        Offsets are seconds relative to the keyframe, compared at 0.01 s
        rounding; "prev"/"next"
        take the immediately adjacent sweep (repeatable, and relative to the
        previous match when mixed with numeric offsets); a numeric offset
        must be hit exactly, and the search on a side aborts once the
        timeline overshoots the current target. Returns {offset: sample_data}
        ascending; a partial dict (=> caller skips the sample) on failure.
        """
        times, chain, k = self._timeline(sample_data)
        diffs = np.round((times - times[k]) / 1e6, 2)
        picked = {0.0: sample_data}

        for direction in (-1, +1):
            adjacent = "prev" if direction < 0 else "next"
            if direction < 0:
                targets = [
                    o for o in reversed(offsets)
                    if o != "next" and (o == "prev" or o < 0)
                ]
            else:
                targets = [
                    o for o in offsets if o != "prev" and (o == "next" or o > 0)
                ]
            pos = k
            for target in targets:
                pos += direction
                if target == adjacent:
                    if not 0 <= pos < len(chain):
                        break
                    picked[float(diffs[pos])] = chain[pos]
                    continue
                # Scan outward until the rounded diff reaches the target.
                while 0 <= pos < len(chain):
                    d = diffs[pos]
                    if d == target or (d - target) * direction > 0:
                        break
                    pos += direction
                if not (0 <= pos < len(chain) and diffs[pos] == target):
                    break
                picked[float(target)] = chain[pos]

        return dict(sorted(picked.items()))

    def _init_imu(self):
        """CAN-bus pose joined to every selected frame, merged with the
        frame's ego_pose (nearest utime, earlier message on ties). The join is a vectorized searchsorted over
        each scene's chronological pose stream."""
        frames_by_scene = defaultdict(dict)
        for sds in self.samples:
            any_sd = next(iter(sds.values()))
            scene_token = self.nuscenes.get("sample", any_sd["sample_token"])[
                "scene_token"
            ]
            name = self.nuscenes.get("scene", scene_token)["name"]
            for sd in sds.values():
                frames_by_scene[name][sd["token"]] = sd

        for name, frames in frames_by_scene.items():
            poses = self.nusc_can.get_messages(scene_name=name, message_name="pose")
            order = np.argsort(
                np.asarray([p["utime"] for p in poses], np.int64), kind="stable"
            )
            poses = [poses[j] for j in order]
            utimes = np.asarray([p["utime"] for p in poses], np.int64)
            sds = list(frames.values())
            stamps = np.asarray([sd["timestamp"] for sd in sds], np.int64)
            hi = np.clip(np.searchsorted(utimes, stamps), 0, len(utimes) - 1)
            lo = np.clip(hi - 1, 0, len(utimes) - 1)
            nearest = np.where(
                np.abs(utimes[lo] - stamps) <= np.abs(utimes[hi] - stamps), lo, hi
            )
            for sd, j in zip(sds, nearest):
                ego = self.nuscenes.get("ego_pose", sd["ego_pose_token"])
                self.imus[sd["token"]] = dict(poses[int(j)], **ego)

    def __len__(self):
        return len(self.samples)

    def _get_imu(self, sds):
        L = len(sds)
        translation = np.empty((L, 3), np.float32)
        acceleration = np.empty((L, 3), np.float32)
        rotation = np.empty((L, 4), np.float32)
        rotation_rate = np.empty((L, 3), np.float32)
        speed = np.empty((L, 1), np.float32)
        for l, (_, sd) in enumerate(sds.items()):
            imu = self.imus[sd["token"]]
            translation[l] = imu["translation"]
            acceleration[l] = imu["accel"]
            rotation[l] = imu["rotation"]
            rotation_rate[l] = imu["rotation_rate"]
            speed[l] = imu["vel"][0]
        translation, rotation = relative_pose(translation, rotation)
        return translation, acceleration, rotation, rotation_rate, speed

    def __getitem__(self, idx):
        sds = self.samples[idx]
        keyframe = sds[0]
        if 0 not in self.frame_offsets:
            sds = {k: v for k, v in sds.items() if k != 0}

        video = np.stack(
            [
                read_image_rgb(os.path.join(self.root_path, sd["filename"]))
                for sd in sds.values()
            ]
        )
        if not self.device_normalize:
            video = remap_and_normalize(video)
        annotated_frame_idx = (
            self.annotated_frame_idx_override
            if self.annotated_frame_idx_override is not None
            else self.frame_offsets.index(0.0)
        )
        imu = self._get_imu(sds)

        annos = self.object_anns_dict[keyframe["token"]]
        boxes = (
            np.stack([np.asarray(o["bbox_corners"], np.float32) for o in annos])
            if annos
            else np.zeros((0, 4), np.float32)
        )
        classes = np.asarray(
            [CATEGORY_MAP[o["category_name"]] for o in annos], np.int64
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
            "temporal_offsets": np.asarray(list(sds.keys()), np.float32),
            "idf": f"{idx}",
        }
