"""The port's real-data pipeline against the JAX package's, on the CPU: the
joint transforms, `relative_pose`, the nuScenes and nuImages datasets on the
fabricated archives of tests/test_dataset_files.py (its file-boundary
devkit stubs), the worker-process loader, and the uint8 video path.

Each random transform and dataset draws from Python's `random` and from
`np.random` exactly as the JAX one does, so under one seed both give the
same crops, flips and frame offsets. Video is held to the resize's
tolerance (float32: RESIZE_F32_ATOL, 4e-7 of the normalized frames' span of
2.64, measured 6.0e-7; uint8: bit for bit), every other key exactly.

Under `device_normalize` the JAX datasets return the uint8 pixels cast to
float32 (future_od_tpu/data/nu_scenes.py:337, nu_images.py:252), so the JAX
backbone, which normalizes only uint8 video, sees raw 0-255 values; the port
returns uint8 (ROADMAP.md Queue 3). The port's model on that uint8 batch is
held against the JAX model on the normalized float32 batch, in one JAX
compile with the check that `encode_offset` does not reach the flagship's
output. About 17 s alone.
"""
import random

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from future_od_tpu.data import nu_images as jax_nu_images
from future_od_tpu.data import nu_scenes as jax_nu_scenes
from future_od_tpu.data import transforms as JT
from future_od_tpu.models.build import build_flagship as jax_build_flagship
from future_od_tpu.models.st_detr import SpatioTemporalDETRArgs as JaxArgs
from future_od_tpu.ops.quaternion import relative_pose as jax_relative_pose
from future_od_tpu.utils.checkpoint_convert import convert_reference_checkpoint

from future_od_tpu_torch.data import loader as port_loader
from future_od_tpu_torch.data import nu_images, nu_scenes
from future_od_tpu_torch.data import transforms as T
from future_od_tpu_torch.data.synthetic import SyntheticClipDataset
from future_od_tpu_torch.models.build import build_flagship
from future_od_tpu_torch.models.st_detr import SpatioTemporalDETRArgs
from future_od_tpu_torch.ops.quaternion import relative_pose
from test_dataset_files import (
    build_nuimages_archive,
    build_nuscenes_archive,
    install_file_devkits,
)

RESIZE_F32_ATOL = 1e-6


def seed_all(seed):
    random.seed(seed)
    np.random.seed(seed)


def frames(dtype, L=3, H=90, W=160, seed=0):
    rng = np.random.default_rng(seed)
    u8 = rng.integers(0, 256, (L, H, W, 3), dtype=np.uint8)
    return u8 if dtype == np.uint8 else T.remap_and_normalize(u8)


def boxes_and_classes(seed=1, n=6, H=90, W=160):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(0, 1, (n, 2)) * [W, H]
    boxes = np.concatenate([lo, lo + rng.uniform(2, 60, (n, 2))], -1).astype(np.float32)
    return boxes, rng.integers(0, 8, n)


TRANSFORMS = {
    "Compose": lambda m: m.JointCompose([m.JointNoOpTransform(), m.JointResize((64, 96))]),
    "NoOp": lambda m: m.JointNoOpTransform(),
    "Resize": lambda m: m.JointResize((64, 128)),
    "CenterCrop": lambda m: m.JointCenterCrop((64, 100)),
    "RandomCrop": lambda m: m.JointRandomCrop((64, 100)),
    "RandomSizedCrop": lambda m: m.RandomSizedCrop(0.5, 1.0),
    "CenterBiasedRandomSizedCrop": lambda m: m.CenterBiasedRandomSizedCrop(0.5, 1.0),
    "HorizontalFlip": lambda m: m.JointHorizontalFlip(0.5),
    "RandomSelect": lambda m: m.RandomSelect(m.JointHorizontalFlip(1.0),
                                             m.JointCenterCrop((80, 150)), 0.5),
    "SizeFilter": lambda m: m.SizeFilter(0.02),
    "Train": lambda m: m.JointCompose([m.RandomSizedCrop(0.5, 1.0), m.JointResize((48, 80))]),
}


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_equals_jax(name, dtype):
    for seed in range(4):
        images, (boxes, classes) = frames(dtype, seed=seed), boxes_and_classes(seed)
        seed_all(seed)
        ref = TRANSFORMS[name](JT)(images.copy(), boxes.copy(), classes.copy())
        seed_all(seed)
        out = TRANSFORMS[name](T)(images.copy(), boxes.copy(), classes.copy())
        assert out[0].dtype == ref[0].dtype and out[0].shape == ref[0].shape
        if dtype == np.uint8:
            np.testing.assert_array_equal(out[0], ref[0])
        else:
            np.testing.assert_allclose(out[0], ref[0], rtol=0, atol=RESIZE_F32_ATOL)
        np.testing.assert_array_equal(out[1], ref[1])
        np.testing.assert_array_equal(out[2], ref[2])
    # both consumed the same draws from both streams
    seed_all(0)
    TRANSFORMS[name](JT)(images.copy(), boxes.copy(), classes.copy())
    after_jax = (random.random(), np.random.random())
    seed_all(0)
    TRANSFORMS[name](T)(images.copy(), boxes.copy(), classes.copy())
    assert (random.random(), np.random.random()) == after_jax


def test_relative_pose_equals_jax():
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    t = rng.normal(size=(5, 3)).astype(np.float32)
    for ours, theirs in zip(relative_pose(t, q), jax_relative_pose(t, q)):
        np.testing.assert_array_equal(ours, theirs)


# ---------------------------------------------------------------------------
# the datasets on the fabricated archives


def assert_samples_equal(ours, theirs, uint8):
    assert set(ours) == set(theirs)
    for key, value in theirs.items():
        if key == "video":
            if uint8:
                # the JAX dataset's float32 copy of the same uint8 pixels
                assert ours[key].dtype == np.uint8 and value.dtype == np.float32
                np.testing.assert_array_equal(ours[key].astype(np.float32), value)
            else:
                assert ours[key].dtype == value.dtype == np.float32
                np.testing.assert_allclose(ours[key], value, rtol=0, atol=RESIZE_F32_ATOL)
        elif isinstance(value, np.ndarray):
            assert ours[key].dtype == value.dtype, key
            np.testing.assert_array_equal(ours[key], value, err_msg=key)
        else:
            assert ours[key] == value, key


def nuscenes_pair(tmp_path, monkeypatch, **kw):
    install_file_devkits(monkeypatch)
    root = build_nuscenes_archive(str(tmp_path))
    made = []
    for module, tm in ((jax_nu_scenes, JT), (nu_scenes, T)):
        made.append(module.NuScenesDataset(
            root_path=root, split="mini_train", front_camera_only=True,
            frame_offsets=[-1.0, -0.5, 0], joint_transform=tm.JointCompose(
                [tm.RandomSizedCrop(0.6, 1.0), tm.JointResize((64, 128))]), **kw))
    return made


@pytest.mark.parametrize("device_normalize", [False, True])
def test_nuscenes_sample_equals_jax(tmp_path, monkeypatch, device_normalize):
    jds, ds = nuscenes_pair(tmp_path, monkeypatch, device_normalize=device_normalize)
    assert len(ds) == len(jds) == 1
    for seed in range(2):
        seed_all(seed)
        theirs = jds[0]
        seed_all(seed)
        assert_samples_equal(ds[0], theirs, device_normalize)


@pytest.mark.parametrize("device_normalize", [False, True])
def test_nuimages_sample_equals_jax(tmp_path, monkeypatch, device_normalize):
    install_file_devkits(monkeypatch)
    root = build_nuimages_archive(str(tmp_path))
    jds, ds = (module.NuImagesDataset(
        root_path=root, split="mini", front_camera_only=True, frames=[3, 4, 5],
        max_frame_random_offset=1, annotated_frame_idx_override=2,
        device_normalize=device_normalize,
        joint_transform=tm.JointCompose([tm.RandomSizedCrop(0.6, 1.0),
                                         tm.JointResize((64, 128))]))
        for module, tm in ((jax_nu_images, JT), (nu_images, T)))
    assert len(ds) == len(jds) == 1
    for seed in range(3):  # the random frame offset takes both values
        seed_all(seed)
        theirs = jds[0]
        seed_all(seed)
        assert_samples_equal(ds[0], theirs, device_normalize)


def test_nuscenes_filter_offsets_and_prev_equal_jax(tmp_path, monkeypatch):
    install_file_devkits(monkeypatch)
    root = build_nuscenes_archive(str(tmp_path))
    for offsets, filt in ((["prev", "prev", 0], ["prev", -0.25, 0]),
                          ([-0.5, -0.25, 0], [-3.0, 0])):
        jds, ds = (module.NuScenesDataset(
            root_path=root, split="mini_train", front_camera_only=True,
            frame_offsets=offsets, filter_offsets=filt,
            joint_transform=tm.JointCompose([tm.JointResize((48, 64))]))
            for module, tm in ((jax_nu_scenes, JT), (nu_scenes, T)))
        assert len(ds) == len(jds)
        for i in range(len(ds)):
            assert_samples_equal(ds[i], jds[i], False)


def test_device_normalize_fault_is_pinned(tmp_path, monkeypatch):
    """The JAX dataset under device_normalize returns float32 pixels of
    0-255 (which its backbone does not normalize); the port returns uint8."""
    jds, ds = nuscenes_pair(tmp_path, monkeypatch, device_normalize=True)
    theirs, ours = jds[0]["video"], ds[0]["video"]
    assert theirs.dtype == np.float32 and theirs.max() > 1.0
    assert ours.dtype == np.uint8


# ---------------------------------------------------------------------------
# the worker-process loader


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_worker_loader_order_equals_the_thread_loader(shuffle, drop_last):
    kw = dict(batch_size=3, shuffle=shuffle, seed=5, drop_last=drop_last, num_workers=2)
    dataset = SyntheticClipDataset(num_samples=10, image_size=(48, 48), max_objects=1)
    threads, workers = port_loader.Loader(dataset, **kw), port_loader.WorkerLoader(dataset, **kw)
    assert len(threads) == len(workers)
    for epoch in (1, 2):
        threads.set_epoch(epoch)
        workers.set_epoch(epoch)
        a = [b["idf"] for b in threads]
        b = [b["idf"] for b in workers]
        assert a == b and len(a) == len(threads)
        assert all(isinstance(batch["video"], np.ndarray) for batch in workers)


# ---------------------------------------------------------------------------
# the model on uint8 video, and encode_offset


TINY = dict(num_classes=8, num_queries=12, hidden_dim=32, enc_layers=1, dec_layers=2,
            dim_feedforward=64, enc_nheads=4, nheads=4, dropout=0.0)


def test_uint8_batch_and_encode_offset_equal_jax(tmp_path, monkeypatch):
    """The port on the uint8 batch (normalized on the device) against the JAX
    model on the same pixels normalized on the host; and the JAX flagship with
    encode_offset on and off against the port (the flagship's core encodes
    no temporal positions, so the offsets do not reach its output)."""
    install_file_devkits(monkeypatch)
    root = build_nuscenes_archive(str(tmp_path))
    ds = nu_scenes.NuScenesDataset(
        root_path=root, split="mini_train", front_camera_only=True,
        frame_offsets=["prev", -0.25, 0], device_normalize=True,
        joint_transform=T.JointCompose([T.JointResize((64, 96))]))
    batch = port_loader.collate([ds[0], ds[0]])
    u8 = {k: v for k, v in batch.items() if isinstance(v, np.ndarray)}
    assert u8["video"].dtype == np.uint8
    f32 = dict(u8, video=T.remap_and_normalize(u8["video"]))

    model = build_flagship(SpatioTemporalDETRArgs(**TINY), device="cpu",
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        model._model.detector.class_embed.bias.normal_(0, 1.0)
        ours_u8 = model.eval()({k: torch.as_tensor(v) for k, v in u8.items()})
        ours_f32 = model({k: torch.as_tensor(v) for k, v in f32.items()})
    jmodels = [jax_build_flagship(JaxArgs(**TINY, encode_offset=flag)) for flag in (False, True)]
    jdata = {k: jnp.asarray(v) for k, v in f32.items()}
    shapes = jax.eval_shape(lambda: jmodels[1].init({"params": jax.random.key(0)}, jdata))
    variables = jax.tree.map(jnp.asarray, convert_reference_checkpoint(
        {k: v.numpy() for k, v in model.state_dict().items()}, shapes, dim=TINY["hidden_dim"]))
    off, on = jax.jit(lambda v, d: [m.apply(v, d) for m in jmodels])(variables, jdata)
    for key in ("pred_logits", "pred_boxes"):
        np.testing.assert_array_equal(np.asarray(off[key]), np.asarray(on[key]))
        for ours in (ours_u8, ours_f32):
            np.testing.assert_allclose(ours[key].numpy(), np.asarray(off[key]), rtol=0,
                                       atol=2e-5, err_msg=key)
