"""The run scripts' loader functions (port of runs/_loader.py).

`--synthetic` swaps in the synthetic moving-box dataset at the requested
resolution, so the whole pipeline runs with no data mounted; `--debug` and
`--short_train` take its 64-clip train split (and `--debug` its 16-clip
validation split). The nuScenes and nuImages datasets, with their JPEG
decode and joint transforms, are not ported yet: without `--synthetic` the
functions raise.
"""
from __future__ import annotations

from future_od_tpu_torch.data.loader import VAL_SEED, Loader
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset


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


def _refuse_real_data(name: str):
    raise NotImplementedError(
        f"the {name} dataset (JPEG decode, joint transforms) is not ported yet "
        "(ROADMAP.md Queue 1 item 2a); run with --synthetic")


def get_nuim_loaders(img_size, offsets, args, config, train_batch_size, random_aug=None,
                     val_annotated_frame_override=None):
    if getattr(args, "synthetic", False):
        return get_synthetic_loaders(img_size, offsets, args, config, train_batch_size)
    _refuse_real_data("nuImages")


def get_nusc_loaders(img_size, offsets, args, config, train_batch_size, random_aug=None,
                     val_annotated_frame_override=None, filter_offsets=None):
    if getattr(args, "synthetic", False):
        return get_synthetic_loaders(img_size, offsets, args, config, train_batch_size)
    _refuse_real_data("nuScenes")


def _make_loader(args, dataset, **kw):
    """The thread-pool Loader (`--loader thread`); `--s2d` packs each
    sample's video 2x2 into 12 channels on the host."""
    if getattr(args, "loader", "thread") == "grain":
        raise NotImplementedError(
            "--loader grain is not ported yet (ROADMAP.md Queue 1 item 2b)")
    if getattr(args, "s2d", False):
        kw["space_to_depth"] = True
    return Loader(dataset, **kw)


def _build_loaders(args, train_batch_size, training_data, validation_data):
    if getattr(args, "device_normalize", False):
        raise NotImplementedError(
            "--device_normalize (uint8 video from the nuScenes/nuImages datasets) is "
            "not ported yet (ROADMAP.md Queue 1 item 2a)")
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
