"""The run scripts' loader functions (port of runs/_loader.py).

Train = random-sized crop + resize; val = center crop, in the fixed
validation order. `--debug` and `--short_train` take the mini splits and
batch 2; `--synthetic` swaps in the synthetic moving-box dataset at the
requested resolution (64 train clips under `--debug`/`--short_train`, 16
validation clips under `--debug`), so the whole pipeline runs with no data
mounted. `--device_normalize` has the datasets emit uint8 video, which the
backbone normalizes on the device; `--loader grain` loads in worker
processes (`data/loader.py::WorkerLoader`). In a multi-process run each rank
loads only its block of every batch's rows (`Loader(shard=...)`).
"""
from __future__ import annotations

from typing import Tuple

import future_od_tpu_torch.data.transforms as T
from future_od_tpu_torch.data import nu_images, nu_scenes
from future_od_tpu_torch.data.loader import VAL_SEED, Loader, WorkerLoader
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.parallel import distributed


def _split_offsets(offsets):
    if isinstance(offsets, dict):
        assert "train" in offsets and "val" in offsets
        return offsets["train"], offsets["val"]
    return offsets, offsets


def get_synthetic_loaders(img_size, offsets, args, config, train_batch_size, num_frames=None):
    """The synthetic stand-in, with the real functions' (train, {val0: ...})
    contract."""
    del config
    train_offsets, val_offsets = _split_offsets(offsets)
    num_frames = num_frames or len(train_offsets)
    numeric = [o if not isinstance(o, str) else -0.05 * (i + 1)
               for i, o in enumerate(train_offsets)]
    n_train = 64 if (args.debug or args.short_train) else 2048
    training_data = SyntheticClipDataset(
        num_samples=n_train, num_frames=num_frames,
        image_size=img_size, temporal_offsets=numeric, seed=1,
    )
    validation_data = SyntheticClipDataset(
        num_samples=16 if args.debug else 128, num_frames=num_frames,
        image_size=img_size, temporal_offsets=numeric, seed=2,
    )
    return _build_loaders(args, train_batch_size, training_data, validation_data)


def get_nuim_loaders(img_size: Tuple[int, int], offsets, args, config, train_batch_size: int,
                     random_aug=None, val_annotated_frame_override=None):
    if getattr(args, "synthetic", False):
        return get_synthetic_loaders(img_size, offsets, args, config, train_batch_size)
    train_offsets, val_offsets = _split_offsets(offsets)
    random_aug = random_aug or T.RandomSizedCrop(0.5, 1.0)
    device_normalize = getattr(args, "device_normalize", False)
    training_data = nu_images.NuImagesDataset(
        root_path=config["nuimages_path"],
        split="mini" if args.debug or args.short_train else "train",
        night=args.night,
        front_camera_only=True,
        joint_transform=T.JointCompose([random_aug, T.JointResize(size=img_size)]),
        frames=[nu_images.ANNOTATED_FRAME + o for o in train_offsets],
        device_normalize=device_normalize,
    )
    print("Loaded training set with", len(training_data), "samples")
    validation_data = nu_images.NuImagesDataset(
        root_path=config["nuimages_path"],
        split="mini" if args.debug else "val",
        night=args.night,
        front_camera_only=True,
        max_frame_random_offset=0,
        joint_transform=T.JointCompose([T.JointCenterCrop(size=img_size)]),
        frames=[nu_images.ANNOTATED_FRAME + o for o in val_offsets],
        annotated_frame_idx_override=val_annotated_frame_override,
        device_normalize=device_normalize,
    )
    print("Loaded validation set with", len(validation_data), "samples")
    return _build_loaders(args, train_batch_size, training_data, validation_data)


def get_nusc_loaders(img_size: Tuple[int, int], offsets, args, config, train_batch_size: int,
                     random_aug=None, val_annotated_frame_override=None, filter_offsets=None):
    if getattr(args, "synthetic", False):
        return get_synthetic_loaders(img_size, offsets, args, config, train_batch_size)
    train_offsets, val_offsets = _split_offsets(offsets)
    random_aug = random_aug or T.RandomSizedCrop(0.5, 1.0)
    device_normalize = getattr(args, "device_normalize", False)
    training_data = nu_scenes.NuScenesDataset(
        root_path=config["nuscenes_path"],
        split="mini_train" if args.debug or args.short_train else "train",
        night=args.night,
        front_camera_only=True,
        joint_transform=T.JointCompose([random_aug, T.JointResize(size=img_size)]),
        frame_offsets=train_offsets,
        filter_offsets=filter_offsets,
        device_normalize=device_normalize,
    )
    print("Loaded training set with", len(training_data), "samples")
    validation_data = nu_scenes.NuScenesDataset(
        root_path=config["nuscenes_path"],
        split="mini_val" if args.debug else "val",
        night=args.night,
        front_camera_only=True,
        joint_transform=T.JointCompose([T.JointCenterCrop(size=img_size)]),
        frame_offsets=val_offsets,
        annotated_frame_idx_override=val_annotated_frame_override,
        filter_offsets=filter_offsets,
        device_normalize=device_normalize,
    )
    print("Loaded validation set with", len(validation_data), "samples")
    return _build_loaders(args, train_batch_size, training_data, validation_data)


def _make_loader(args, dataset, **kw):
    """`--loader thread` (the thread-pool Loader: the JPEG decode and the
    resize release the interpreter lock) or `--loader grain` (worker
    processes, for datasets whose Python work holds it); `--s2d` packs each
    sample's video 2x2 into 12 channels on the host."""
    if getattr(args, "s2d", False):
        kw["space_to_depth"] = True
    if distributed.is_initialized():  # each rank loads its rows of every batch
        kw["shard"] = (distributed.rank(), distributed.world_size())
    if getattr(args, "loader", "thread") == "grain":
        return WorkerLoader(dataset, **kw)
    return Loader(dataset, **kw)


def _build_loaders(args, train_batch_size, training_data, validation_data):
    num_workers = getattr(args, "num_workers", 16)
    train_bs = (
        min(2, train_batch_size)
        if (args.debug or args.short_train) and not getattr(args, "synthetic", False)
        else train_batch_size
    )
    training_loader = _make_loader(
        args,
        training_data,
        batch_size=min(train_bs, len(training_data)),
        shuffle=True,
        drop_last=True,
        num_workers=num_workers,
    )
    validation_loader = {
        "val0": _make_loader(
            args,
            validation_data,
            batch_size=min(2 if args.debug else 12, len(validation_data)),
            shuffle=False,
            seed=VAL_SEED,
            drop_last=False,
            num_workers=num_workers,
        ),
    }
    return training_loader, validation_loader
